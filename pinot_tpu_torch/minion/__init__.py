"""Minion: stateless task execution framework + built-in tasks (the
port of pinot_tpu/minion/).

Reference analogue: pinot-minion (BaseMinionStarter, task registry via
@TaskExecutorFactory) + the Helix task framework orchestration on the
controller (PinotTaskManager, PinotHelixTaskResourceManager —
pinot-controller/.../helix/core/minion/) + built-in tasks
(pinot-plugins/pinot-minion-tasks/pinot-minion-builtin-tasks/).
"""

from .framework import MinionInstance, PinotTaskManager, TaskSpec
from . import tasks  # noqa: F401 — registers built-in executors

__all__ = ["MinionInstance", "PinotTaskManager", "TaskSpec"]
