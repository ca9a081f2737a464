"""Host ms per keyframe of `LocalMapper.process_keyframe` and the inline
`LoopCloser.process_keyframe`, each ending in a device sync, mean over the
window's keyframes."""


def read(ctx):
    mapper = ctx["timer_ms"].get("keyframe.mapper", [])
    if not mapper:
        return None
    loop = ctx["timer_ms"].get("keyframe.loopcloser", [])
    return (sum(mapper) + sum(loop)) / len(mapper)
