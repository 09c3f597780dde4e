"""Core round pieces: task, server, health, round state."""

from blades_tpu_torch.core.round import FedRound, RoundState  # noqa: F401
from blades_tpu_torch.core.server import Server, ServerState  # noqa: F401
from blades_tpu_torch.core.task import Task, TaskSpec  # noqa: F401
