"""Host-level fault handling of the sweep runner (counterpart of
``blades_tpu/faults/``; the in-round fault injector is not in the port
yet)."""
