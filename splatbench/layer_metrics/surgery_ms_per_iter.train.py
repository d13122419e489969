"""Milliseconds of the window's surgery calls (Trainer.step on an event
iteration: the dead-prune of train/densify.py), summed over their host
spans, per iteration of the whole window.  With group_ms_per_iter.train
it adds up to train_ms_per_iter."""


def read(record, trace):
    if record.get("kind") != "train" or not record["iterations"]:
        return None
    spent = sum(e - s for kind, s, e, _ in record["spans"] if kind == "step")
    return 1e3 * spent / record["iterations"]
