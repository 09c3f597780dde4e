"""Mini obs-schema module of the port (blades-lint fixture, never
imported)."""

ROUND_RECORD_FIELDS = {
    "train_loss": ((int, float), True),
    "test_acc": ((int, float), False),
    "never_stamped": ((int,), False),  # -> registered-but-unstamped WARNING
}
