"""The `keyframe` span's ms (a keyframe's mapping and loop detection, on
the tracking thread or the mapping worker) less its `local_ba` child's,
mean per keyframe of the window. Reads the port's spans (`ctx["spans"]`),
as `local_ba_ms` does."""


def read(ctx):
    spans = ctx.get("spans") or ()
    rest = {s["id"]: s["ms"] for s in spans if s["name"] == "keyframe"}
    if not rest:
        return None
    for s in spans:
        if s["name"] == "local_ba" and s["parent"] in rest:
            rest[s["parent"]] -= s["ms"]
    return sum(rest.values()) / len(rest)
