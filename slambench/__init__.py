"""The benchmark of the PyTorch and CUDA port (`orb_slam3_comments_ghr_torch`):
EuRoC replays through `SLAM.track_stereo` / `track_monocular` on one card.
Run a cell with `python -m slambench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`."""
