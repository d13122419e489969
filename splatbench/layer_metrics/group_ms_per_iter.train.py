"""Milliseconds of the window's step-group calls (Trainer.step_group),
summed over their host spans, per iteration of the whole window."""


def read(record, trace):
    if record.get("kind") != "train" or not record["iterations"]:
        return None
    spent = sum(e - s for kind, s, e, _ in record["spans"] if kind == "group")
    return 1e3 * spent / record["iterations"]
