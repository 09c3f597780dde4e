"""Round-record stamps of the port fully covered by the mini schema
(fixture): a literal loop's keys reach only its own stores."""


def fill_row(self, row, metrics, state):
    self._last_eval = {k: float(metrics[k]) for k in ("test_acc",)}
    row["train_loss"] = metrics["train_loss"]
    for k in ("unregistered_attr",):  # a loop that stamps no row
        setattr(state, k, None)
    return row
