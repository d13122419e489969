"""Host milliseconds per traced iteration that Trainer.step_group spends
before its replays and after its host read, while the card waits: the
program's spans r3dgs.step_group.prepare and unpack (its span read holds
the wait for the card, and is left out)."""

from splatbench.program_trace import span_ms

PARTS = tuple(f"r3dgs.step_group.{p}" for p in ("prepare", "unpack"))


def read(record, trace):
    return span_ms(record, "train", PARTS)
