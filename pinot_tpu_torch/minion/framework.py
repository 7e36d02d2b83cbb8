"""Minion task framework: generation, queueing, claiming, execution.

Reference analogue: the Helix task framework as Pinot uses it —
PinotTaskManager generates task configs from each table's taskConfig
(pinot-controller/.../helix/core/minion/PinotTaskManager.java), tasks queue
in ZK, minions claim and run them via registered executors
(pinot-minion/.../taskfactory/TaskFactoryRegistry.java). Store layout:

  /TASKS/{taskType}/{taskId} → {state: PENDING|RUNNING|COMPLETED|ERROR,
                                table, config, owner, output, error}

The port's copy of pinot_tpu/minion/framework.py. A minion has a device
(the card by default): a task that evaluates a filter over a segment
(PurgeTask) runs it on that device's planes.
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..cluster.controller import ClusterController
from ..cluster.store import BadVersionError, PropertyStore

PENDING = "PENDING"
RUNNING = "RUNNING"
COMPLETED = "COMPLETED"
ERROR = "ERROR"


@dataclass
class TaskSpec:
    task_type: str
    table: str  # tableNameWithType
    config: dict = field(default_factory=dict)
    task_id: str = ""

    def path(self) -> str:
        return f"/TASKS/{self.task_type}/{self.task_id}"


# taskType → generator(controller, table, task_cfg) -> list[TaskSpec]
_GENERATORS: dict[str, Callable] = {}
# taskType → executor(ctx, spec) -> dict (output)
_EXECUTORS: dict[str, Callable] = {}


def register_task_generator(task_type: str, fn: Callable) -> None:
    _GENERATORS[task_type] = fn


def register_task_executor(task_type: str, fn: Callable) -> None:
    _EXECUTORS[task_type] = fn


class PinotTaskManager:
    """Controller-side: reads each table's taskConfigs and enqueues task
    specs (reference: PinotTaskManager.scheduleTasks)."""

    def __init__(self, store: PropertyStore, controller: ClusterController):
        self.store = store
        self.controller = controller

    def schedule_tasks(self, table: Optional[str] = None,
                       task_type: Optional[str] = None) -> list[str]:
        tables = [table] if table else self.store.children("/CONFIGS/TABLE")
        scheduled = []
        for t in tables:
            cfg = self.controller.table_config(t) or {}
            for ttype, task_cfg in (cfg.get("taskConfigs") or {}).items():
                if task_type and ttype != task_type:
                    continue
                gen = _GENERATORS.get(ttype)
                if gen is None:
                    raise ValueError(f"no generator for task type {ttype}")
                for spec in gen(self.controller, t, task_cfg or {}):
                    spec.task_id = spec.task_id or f"{ttype}_{uuid.uuid4().hex[:12]}"
                    self.store.set(spec.path(), {
                        "state": PENDING, "table": spec.table,
                        "taskType": spec.task_type, "config": spec.config,
                        "owner": None, "output": None, "error": None,
                        "scheduledAtMs": int(time.time() * 1000)})
                    scheduled.append(spec.task_id)
        return scheduled

    def task_state(self, task_type: str, task_id: str) -> Optional[dict]:
        return self.store.get(f"/TASKS/{task_type}/{task_id}")

    def wait_all(self, timeout_s: float = 30.0) -> bool:
        """Wait for every queued task to reach a terminal state."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            states = []
            for ttype in self.store.children("/TASKS"):
                for tid in self.store.children(f"/TASKS/{ttype}"):
                    states.append(self.store.get(f"/TASKS/{ttype}/{tid}")["state"])
            if all(s in (COMPLETED, ERROR) for s in states):
                return True
            time.sleep(0.02)
        return False


@dataclass
class TaskContext:
    """What executors get to work with (reference: MinionContext +
    controller API access through MinionTaskBaseObserver helpers)."""

    store: PropertyStore
    controller: ClusterController
    work_dir: str
    device: str = "cuda"


class MinionInstance:
    """Claims PENDING tasks via CAS and runs registered executors
    (reference: BaseMinionStarter + TaskFactoryRegistry; the Helix task
    runner thread pool becomes a poll thread here). ``device`` is where
    a task's device work runs: the card unless the caller passes "cpu"."""

    def __init__(self, store: PropertyStore, instance_id: str,
                 controller: ClusterController, work_dir: str,
                 poll_interval_s: float = 0.02, device: str = "cuda"):
        self.store = store
        self.instance_id = instance_id
        self.controller = controller
        self.work_dir = work_dir
        self.device = device
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tasks_run = 0

    def start(self) -> None:
        self.store.set(f"/INSTANCECONFIGS/{self.instance_id}",
                       {"type": "MINION", "tags": ["minion_untagged"]})
        self.store.set(f"/LIVEINSTANCES/{self.instance_id}", {"type": "MINION"},
                       ephemeral_owner=self.instance_id)
        self._thread = threading.Thread(target=self._poll_loop,
                                        name=f"minion-{self.instance_id}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10)
        self.store.expire_session(self.instance_id)

    def run_pending_once(self) -> int:
        """Synchronous drain for tests/CLI."""
        n = 0
        while self._claim_and_run_one():
            n += 1
        return n

    # -- internals ----------------------------------------------------------
    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            if not self._claim_and_run_one():
                time.sleep(self.poll_interval_s)

    def _claim_and_run_one(self) -> bool:
        for ttype in self.store.children("/TASKS"):
            for tid in self.store.children(f"/TASKS/{ttype}"):
                path = f"/TASKS/{ttype}/{tid}"
                task, version = self.store.get_with_version(path)
                if task is None or task["state"] != PENDING:
                    continue
                claimed = dict(task, state=RUNNING, owner=self.instance_id)
                try:
                    self.store.set(path, claimed, expected_version=version)
                except BadVersionError:
                    continue  # another minion won the claim
                self._execute(path, claimed)
                return True
        return False

    def _execute(self, path: str, task: dict) -> None:
        executor = _EXECUTORS.get(task["taskType"])
        ctx = TaskContext(self.store, self.controller, self.work_dir,
                          self.device)
        spec = TaskSpec(task["taskType"], task["table"], task["config"],
                        path.rsplit("/", 1)[-1])
        try:
            if executor is None:
                raise ValueError(f"no executor for {task['taskType']}")
            output = executor(ctx, spec)
            self.store.update(path, lambda t: dict(
                t, state=COMPLETED, output=output))
        except Exception as e:
            self.store.update(path, lambda t: dict(
                t, state=ERROR, error=f"{type(e).__name__}: {e}",
                traceback=traceback.format_exc()[-2000:]))
        finally:
            self.tasks_run += 1
