"""Host milliseconds per traced frame that the program's frame entry
(render.py FrameServer.frame) spends on its own work: the span
r3dgs.serve.frame less its r3dgs.serve.replay (the graph launch, whose
cost under the traced window's profiler is the profiler's) and its
r3dgs.serve.read (the wait for the card).  What is left is the pose
copy's launch and the entry's Python."""

from splatbench.program_trace import span_ms


def read(record, trace):
    frame = span_ms(record, "view", ("r3dgs.serve.frame",),
                    once_per_unit=True)
    inner = span_ms(record, "view", ("r3dgs.serve.replay",
                                     "r3dgs.serve.read"))
    return None if frame is None or inner is None else frame - inner
