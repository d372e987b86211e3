"""Crash-safe engine snapshots and bit-exact restore.

Port of ``src/repro/serve/recovery.py``: the same snapshot format, so a
snapshot written by either package restores in the other.

Extends the may-lose/never-corrupt contract (ROADMAP "Failure model")
to the serving seam: a serving host can be killed at any engine step and
restored from its last durable snapshot with

* **bit-exact token streams** — the restored engine replays each
  occupied slot's prompt + generated prefix through the same masked
  teacher-forced decode path that produced it, rebuilding the slot's
  KV/recurrent cache state exactly, then resumes decoding from the
  snapshotted pending token. Tokens generated after the snapshot are
  lost by the kill — and regenerated deterministically, so the merged
  stream equals the uninterrupted run's.
* **no double-counted energy** — the accountant's durable shard is
  published through :class:`repro_torch.core.exchange.ShardSpiller`, whose
  epoch fence (``spill`` refuses ``epoch <= resumed epoch``) already
  makes replays idempotent; the snapshot records the accountant's
  ``(epoch, last_spill_epoch)`` fence as provenance so a restore can be
  audited against the shard it resumed from.
* **full provenance** — the scheduler queue, per-request records and
  overload-ladder state ride in the snapshot; every restored request is
  marked ``recovered`` in the
  :class:`~repro_torch.serve.scheduler.ServeReport`.

Self-speculative decoding (``ServeConfig.spec_len``) needs no snapshot
schema of its own: a speculation window is **atomic on the step clock**
(the injected-crash site fires before any mutation, so a killed step
leaves the engine exactly as the previous window published it), which
means snapshots only ever observe window boundaries — the emitted
prefix, pending token and slot lengths the baseline contract already
serializes. The replay path below is the baseline single-token
teacher-forced step, valid for every cache family regardless of how the
tokens were originally produced, so "kill mid-speculation-window and
restore" reduces to the established bit-exact replay; the effective
speculation length after restore is derived from the snapshotted
scheduler ``widened`` flag, so a degraded engine resumes degraded.
Replay energy lands in the ``serve/replay`` phase (as for rollback),
never in the per-token price phases, and the spill-epoch fence above
keeps pre-crash speculation energy from being double-charged.

Snapshots use the shared ``ckpt`` manifest+CRC+rename protocol
(``snap_%09d`` directories plus an atomically-replaced ``LATEST``
pointer), so torn writes are invisible to readers and corruption
surfaces as typed :class:`~repro_torch.core.faults.SpillError`\\ s, never as a
silently wrong engine.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.checkpoint.ckpt import (latest_step, publish_latest,
                                         read_manifest_dir,
                                         write_manifest_dir)
from repro_torch.configs.base import ModelConfig
from repro_torch.core import regions as regions_mod
from repro_torch.core.faults import (MissingArtifactError, TornWriteError,
                                     declare_site, resolve_plan)
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.serve.scheduler import ServeScheduler

__all__ = ["snapshot", "restore_engine"]

# Injection seam this module owns (see faults.FAULT_SITES): transient
# snapshot-publish failures at chosen step-clock values. Byte-level
# corruption of snapshot artifacts needs no site of its own — snapshots
# ride the shared ckpt leaf/manifest codec, so `leaf_faults` matching
# snap paths already covers torn/corrupt snapshot bytes.
_SITE_SNAPSHOT = declare_site("serve.snapshot.write")


def _req_meta(r: Request) -> dict:
    return {"rid": int(r.rid), "max_new_tokens": int(r.max_new_tokens),
            "priority": int(r.priority), "deadline": r.deadline,
            "energy_budget": r.energy_budget, "energy_j": float(r.energy_j),
            "submit_step": int(r.submit_step), "done": bool(r.done)}


def _req_from_meta(m: dict, prompt: np.ndarray,
                   out_tokens: list[int]) -> Request:
    return Request(rid=int(m["rid"]), prompt=np.asarray(prompt, np.int32),
                   max_new_tokens=int(m["max_new_tokens"]),
                   out_tokens=out_tokens, done=bool(m["done"]),
                   priority=int(m["priority"]), deadline=m["deadline"],
                   energy_budget=m["energy_budget"],
                   status="recovered", energy_j=float(m["energy_j"]),
                   submit_step=int(m["submit_step"]))


def snapshot(engine: Engine, path: str, *, faults=None) -> str:
    """Durably publish the engine's recoverable state under ``path``.

    Keyed by the step clock: ``<path>/snap_<step_count>`` plus an
    atomic ``LATEST`` pointer. Contents: the slot table (pending tokens,
    per-slot cache lengths, each occupied slot's prompt and generated
    tokens), the admission queue, the full :class:`ServeReport`, the
    overload-ladder state and the accountant's spill-epoch fence. The
    device cache is deliberately NOT serialized — restore rebuilds it
    deterministically by replaying prefixes, which keeps snapshots
    O(tokens), not O(cache).

    Idempotent per step: re-publishing an existing step's directory is
    a no-op beyond repointing ``LATEST``. Injected failures
    (``FaultPlan.snapshot_failures``) raise a typed transient
    :class:`TornWriteError` before anything is written.
    """
    step = engine.step_count
    plan = resolve_plan(faults if faults is not None else engine._faults)
    if plan is not None and plan.snapshot_fails(step):
        raise TornWriteError(
            f"injected snapshot publish failure at engine step {step} "
            f"({_SITE_SNAPSHOT})")
    final = os.path.join(path, f"snap_{step:09d}")
    if not os.path.isdir(final):
        arrays: list[np.ndarray] = [
            np.asarray(engine.tokens, np.int32),
            np.asarray(engine.slot_len, np.int32)]
        slots_meta: list[dict | None] = []
        for r in engine.slot_req:
            if r is None:
                slots_meta.append(None)
                continue
            sm = _req_meta(r)
            sm["prompt_leaf"] = len(arrays)
            sm["out_leaf"] = len(arrays) + 1
            arrays.append(np.asarray(r.prompt, np.int32))
            arrays.append(np.asarray(r.out_tokens, np.int32))
            slots_meta.append(sm)
        queue_meta: list[dict] = []
        for priority, seq, r in engine.scheduler.queue.snapshot():
            qm = _req_meta(r)
            qm["queue_priority"] = int(priority)
            qm["queue_seq"] = int(seq)
            qm["prompt_leaf"] = len(arrays)
            arrays.append(np.asarray(r.prompt, np.int32))
            queue_meta.append(qm)
        acct = engine.accountant
        fence = None if acct is None else {
            "epoch": acct.epoch, "last_spill_epoch": acct.last_spill_epoch}
        write_manifest_dir(final, arrays, meta={"serve": {
            "step_count": step,
            "max_batch": engine.scfg.max_batch,
            "max_len": engine.scfg.max_len,
            "slots": slots_meta,
            "queue": queue_meta,
            "scheduler": engine.scheduler.state_json(),
            "accountant_fence": fence,
        }})
    publish_latest(path, step)
    return final


def _replay_slot(eng: Engine, s: int, req: Request) -> None:
    """Rebuild slot ``s``'s cache state by teacher-forcing the request's
    prompt + generated prefix through the shared masked decode step —
    the exact positions the live run wrote (prompt token t at position
    t, generated token k at position len(prompt)+k), masked to this
    slot only. Runs the engine's own step functions (``_step_fns``) at
    the shapes of the live run."""
    eng.slot_req[s] = req
    mask = np.zeros(len(eng.slot_req), bool)
    mask[s] = True
    eng.cache = eng._reset_slots(eng.cache, eng._dev(mask))
    toks = [int(t) for t in req.prompt] + [int(t) for t in req.out_tokens]
    cur = eng.slot_len.astype(np.int32).copy()
    with regions_mod.region("serve/replay"):
        for t, tok in enumerate(toks):
            eng.tokens[s, 0] = tok
            cur[s] = t
            # Fresh host buffers each step — same async-dispatch hazard
            # as the prefill loop (see Engine._place).
            _, eng.cache = eng._decode_masked(
                eng.params, eng._dev(eng.tokens.copy()), eng.cache,
                eng._dev(cur.copy()), eng._dev(mask))


def restore_engine(cfg: ModelConfig, params, serve_cfg: ServeConfig,
                   path: str, *, step: int | None = None,
                   sample=None, accountant=None, faults=None,
                   device="cuda") -> Engine:
    """Rebuild an engine from the snapshot at ``step`` (default: LATEST).

    Raises :class:`MissingArtifactError` when no snapshot was ever
    published; CRC mismatches and torn snapshot directories surface as
    the ckpt protocol's typed errors. The returned engine carries
    ``restored_fence`` (the snapshotted accountant spill fence) for
    audit, and its report marks every restored request ``recovered``.
    The engine runs on ``device``, where ``params`` must live.

    To also resume pre-crash *energy* state, pass an ``accountant``
    built with the same ``spill_dir``/``host_id`` as the dead host's —
    :class:`ShardSpiller` resume plus its epoch fence guarantee no
    sample is double-published.
    """
    if step is None:
        step = latest_step(path)
    if step is None:
        raise MissingArtifactError(f"no LATEST snapshot under {path}")
    d = os.path.join(path, f"snap_{step:09d}")
    if not os.path.isdir(d):
        raise MissingArtifactError(
            f"snapshot dir {d} missing (LATEST says step {step})")
    arrays, manifest = read_manifest_dir(d)
    meta = manifest["serve"]
    if (int(meta["max_batch"]) != serve_cfg.max_batch
            or int(meta["max_len"]) != serve_cfg.max_len):
        raise ValueError(
            f"snapshot slot geometry (max_batch={meta['max_batch']}, "
            f"max_len={meta['max_len']}) does not match serve config "
            f"({serve_cfg.max_batch}, {serve_cfg.max_len}); restoring "
            f"across geometries would misplace cache positions")
    sched = ServeScheduler()
    sched.load_state(meta["scheduler"])
    eng = Engine(cfg, params, serve_cfg, sample=sample,
                 accountant=accountant, scheduler=sched, faults=faults,
                 device=device)
    eng.step_count = int(meta["step_count"])
    tokens, slot_len = arrays[0], arrays[1]
    for s, sm in enumerate(meta["slots"]):
        if sm is None:
            continue
        req = _req_from_meta(
            sm, arrays[sm["prompt_leaf"]],
            [int(t) for t in arrays[sm["out_leaf"]]])
        _replay_slot(eng, s, req)
        eng._requests[req.rid] = req
        eng.report.set_status(req.rid, "recovered")
    # The snapshotted pending tokens / lengths overwrite replay
    # scratch: position slot_len is where the next decode step writes.
    eng.tokens[:] = np.asarray(tokens, np.int32)
    eng.slot_len[:] = np.asarray(slot_len, np.int32)
    for qm in meta["queue"]:
        req = _req_from_meta(qm, arrays[qm["prompt_leaf"]], [])
        eng._requests[req.rid] = req
        eng.report.set_status(req.rid, "recovered")
        eng.scheduler.requeue(req, qm["queue_priority"], qm["queue_seq"])
    eng.restored_fence = meta["accountant_fence"]
    return eng
