"""The tools users run beside the engine, ported from the repo's `scripts/`
under the same file names; each runs as `python -m
orb_slam3_comments_ghr_torch.scripts.<name>` and has `main(argv=None)`."""
