"""Round-record stamps of the port with unregistered keys (fixture)."""


def fill_row(row, metrics, state):
    row["train_loss"] = metrics["train_loss"]
    row["mystery_key"] = 1.0  # BAD: not in ROUND_RECORD_FIELDS
    for k in ("test_acc",):
        row[k] = metrics[k]
    row.update({k: metrics[k] for k in ("other_key",)})  # BAD (comprehension)
    for k in ("setattr_only",):  # not a stamp: the loop never stores k
        setattr(state, k, None)
    return row
