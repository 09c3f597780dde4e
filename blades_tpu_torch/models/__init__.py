"""The port's models and their catalog."""

from blades_tpu_torch.models.catalog import get_model, register_model  # noqa: F401
