"""Fault tolerance on the host: preemption, stragglers, the elastic mesh
plan — the host half of the reference's ``distributed/fault_tolerance.py``
(pure Python).

  * :class:`PreemptionHandler` turns SIGTERM into a flag the training
    loop polls; the loop checkpoints and exits cleanly.
  * :class:`StragglerMonitor` keeps a rolling window of step times and
    flags a step slower than μ + k·σ.
  * :func:`plan_elastic_mesh` picks the largest (data, model) mesh the
    surviving devices hold, keeping the model axis whole;
  * :func:`make_elastic_mesh` builds that mesh over the surviving ranks
    of a process group (a rank a device), and :func:`elastic_restart`
    builds it and loads the last good checkpoint. A restart after a
    device is lost is a fresh process group over the survivors
    (:func:`repro_torch.launch.mesh.spawn_ranks`), each rank calling
    :func:`elastic_restart`.
"""

from __future__ import annotations

import collections
import signal
import statistics


class PreemptionHandler:
    """SIGTERM (or the given signals) → a cooperative checkpoint-and-exit
    flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._installed = []
        for sig in signals:
            try:
                prev = signal.signal(sig, self._handle)
                self._installed.append((sig, prev))
            except ValueError:            # not on the main thread
                pass

    def _handle(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def restore(self):
        for sig, prev in self._installed:
            signal.signal(sig, prev)


class StragglerMonitor:
    """Rolling window of step durations with outlier detection."""

    def __init__(self, window: int = 50, threshold_sigma: float = 3.0,
                 min_steps: int = 10):
        self.window = window
        self.sigma = threshold_sigma
        self.min_steps = min_steps
        self.times = collections.deque(maxlen=window)
        self.flagged: list[tuple[int, float]] = []
        self._step = 0

    def record(self, duration_s: float) -> bool:
        """Record a step's time; True if the step is a straggler."""
        self._step += 1
        is_straggler = False
        if len(self.times) >= self.min_steps:
            mu = statistics.fmean(self.times)
            sd = statistics.pstdev(self.times) or 1e-9
            if duration_s > mu + self.sigma * sd:
                is_straggler = True
                self.flagged.append((self._step, duration_s))
        self.times.append(duration_s)
        return is_straggler

    def summary(self) -> dict:
        return {"steps": self._step,
                "mean_s": statistics.fmean(self.times) if self.times else 0.0,
                "flagged": list(self.flagged)}


def plan_elastic_mesh(n_devices: int, *, model: int = 16,
                      pod: int | None = None) -> tuple:
    """The largest (data, model), or (pod, data, model), mesh shape the
    survivors hold; the model axis is kept whole and the data axis
    absorbs the loss."""
    if n_devices < model:
        raise RuntimeError(
            f"{n_devices} devices cannot sustain model axis {model}")
    if pod:
        data = n_devices // pod // model
        if data < 1:
            return plan_elastic_mesh(n_devices, model=model, pod=None)
        return (pod, data, model)
    return (n_devices // model, model)


def make_elastic_mesh(ranks=None, *, model: int = 16, multi_pod=False):
    """The largest healthy mesh over the surviving ``ranks`` of the
    default process group (all of them by default): ``(data, model)``,
    or ``(pod, data, model)`` with ``multi_pod`` (2 pods), over the first
    ``prod(plan)`` survivors in rank order; the spares sit out. Every
    rank of the group calls it (the mesh's groups are made
    collectively); → the mesh, or None on a rank outside it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    ranks = sorted(range(dist.get_world_size()) if ranks is None
                   else ranks)
    shape = plan_elastic_mesh(len(ranks), model=model,
                              pod=2 if multi_pod else None)
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    return make_host_mesh(shape, names, ranks=ranks)


def elastic_restart(ckpt_dir: str, tree_like, surviving_ranks, *,
                    model: int = 16):
    """Recovery after a device is lost: the new mesh over the survivors
    and the last good step. → (mesh, tree, step, extra), the tree whole
    on the host as the checkpoint holds it (the caller cuts its shards
    for the new mesh); mesh None on a spare rank."""
    from repro_torch.checkpoint.store import load_checkpoint
    mesh = make_elastic_mesh(surviving_ranks, model=model)
    tree, step, extra = load_checkpoint(ckpt_dir, tree_like)
    return mesh, tree, step, extra
