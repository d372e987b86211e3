"""Fault-tolerant training loop: checkpoint/restart, preemption hook,
step watchdog (straggler mitigation), optional ALEA online profiling.

Port of ``src/repro/train/trainer.py``. The loop is host-side
orchestration around the step. Fault-tolerance posture:

  * atomic checkpoints every ``ckpt_every`` steps (async write-behind,
    :mod:`repro_torch.checkpoint.ckpt`, the reference's on-disk format);
  * resume-from-LATEST on startup;
  * SIGTERM handler saves a final checkpoint (preemption-safe; one that
    lands inside a step is saved when the step is whole);
  * a watchdog thread flags steps exceeding ``watchdog_factor`` × EMA step
    time — at scale this triggers abort-and-restore; here it records the
    event and (configurably) raises ``StragglerAbort``;
  * ALEA host-mode profiling can run continuously (the paper's capped ~1%
    overhead makes it deployable online).

Where the reference waits for the step with ``jax.block_until_ready``,
the port synchronises the state's device inside the ``train_step``
region: without it the host would run ahead and a step's samples would
land in the next step's ``data_load``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import threading
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core.regions import region
from repro_torch.tree import tree_leaves

__all__ = ["TrainerConfig", "Trainer", "StragglerAbort"]


class StragglerAbort(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    log_every: int = 10
    watchdog_factor: float = 10.0
    watchdog_min_s: float = 30.0
    raise_on_straggler: bool = False


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 state: Any, data_source, *, put_batch=None):
        self.cfg = cfg
        self.train_step = train_step
        self.state = state
        self.data = data_source
        self.put_batch = put_batch or (lambda b: b)
        self.step = 0
        self.straggler_events: list[int] = []
        self.ckpt = ckpt_mod.AsyncCheckpointer(cfg.ckpt_dir)
        self._ema_step_time: float | None = None
        self._watch_deadline: float | None = None
        self._stop_watch = threading.Event()
        self._in_step = False
        self._sigterm = False
        self._install_sigterm()

    # -- fault tolerance ------------------------------------------------------
    def _install_sigterm(self):
        # The step updates the state in place (the reference donates it),
        # so a signal that lands inside it finds some leaves at step N+1
        # and others at N. There the handler only sets a flag, and run()
        # saves and exits once the step is whole; elsewhere it saves now.
        def handler(signum, frame):
            if self._in_step:
                self._sigterm = True
                return
            self._save_and_exit()
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass    # non-main thread (tests)

    def _save_and_exit(self):
        self.ckpt.wait()
        ckpt_mod.save(self.cfg.ckpt_dir, self.step, self.state)
        raise SystemExit(143)

    def try_resume(self) -> bool:
        latest = ckpt_mod.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return False
        self.state, self.step = ckpt_mod.restore(self.cfg.ckpt_dir,
                                                 self.state, latest)
        return True

    # -- watchdog ---------------------------------------------------------------
    def _watchdog(self):
        while not self._stop_watch.wait(0.05):
            d = self._watch_deadline
            if d is not None and time.monotonic() > d:
                self.straggler_events.append(self.step)
                self._watch_deadline = None
                if self.cfg.raise_on_straggler:
                    # At scale: abort slow step, restore from checkpoint,
                    # exclude the slow host. Surfaced here as an exception.
                    raise StragglerAbort(f"step {self.step} exceeded deadline")

    # -- main loop ----------------------------------------------------------------
    def run(self, *, profiler_session=None) -> dict[str, Any]:
        watch = threading.Thread(target=self._watchdog, daemon=True)
        self._stop_watch.clear()
        watch.start()
        metrics_log = []
        try:
            while self.step < self.cfg.total_steps:
                with region("data_load"):
                    batch = self.put_batch(self.data.batch(self.step))
                ema = self._ema_step_time
                budget = max(self.cfg.watchdog_min_s,
                             self.cfg.watchdog_factor * (ema or 1e9))
                self._watch_deadline = time.monotonic() + budget
                t0 = time.monotonic()
                self._in_step = True
                with region("train_step"):
                    self.state, metrics = self.train_step(self.state, batch)
                    leaf = tree_leaves(self.state)[0]
                    if leaf.device.type == "cuda":
                        torch.cuda.synchronize(leaf.device)
                dt = time.monotonic() - t0
                self._watch_deadline = None
                self._ema_step_time = (dt if ema is None
                                       else 0.9 * ema + 0.1 * dt)
                self.step += 1
                self._in_step = False
                if self._sigterm:
                    self._save_and_exit()
                if self.step % self.cfg.log_every == 0:
                    metrics_log.append(
                        {k: float(v) for k, v in metrics.items()}
                        | {"step": self.step, "step_time_s": dt})
                if self.step % self.cfg.ckpt_every == 0:
                    with region("checkpoint"):
                        self.ckpt.save_async(self.step, self.state)
        finally:
            self._in_step = False
            self._stop_watch.set()
            self.ckpt.wait()
        return {"metrics": metrics_log,
                "straggler_events": self.straggler_events,
                "final_step": self.step}
