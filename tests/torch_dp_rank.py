"""One data-parallel QAT step of reduced rwkv6 with the int8 gradient
compression, for ``tests/test_torch_recurrent_training.py`` and phase 4m
(f) of ``chip_smoke.py``: a module of its own, importing neither JAX nor
the test module, so that the gloo ranks ``spawn_ranks`` starts on it
import only torch and the port."""
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.distributed.compression import CompressedMean
from repro_torch.distributed.partitioning import Mesh
from repro_torch.models.transformer import init_params
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train import make_train_step
from repro_torch.tree_util import flatten_with_path, tree_map

WORLD, BATCH, SEQ = 2, 8, 32
STEP = dict(peak_lr=1e-2, warmup=1, total_steps=10)


def setup():
    """Reduced rwkv6 at f32, its seeded masters and batch 8 × 32."""
    cfg = get_config("rwkv6-1.6b-reduced").replace(act_dtype="float32")
    batch = SyntheticDataset(cfg, seq_len=SEQ, global_batch=BATCH,
                             seed=0).batch(0)
    return cfg, init_params(cfg, 0), {k: torch.from_numpy(v)
                                      for k, v in batch.items()}


def dp_step(cfg, params, batch, mesh):
    """One ``make_train_step`` (``STEP``) with ``CompressedMean`` over
    ``mesh``'s data axis. → (params, metrics).

    Over a gloo group ``batch`` is this rank's share. On a single-process
    mesh of n shards it is the whole batch, and the step is what a
    ``shard_map`` of the reference's step runs: shards 1..n-1 take their
    gradients in steps on copies of the masters whose hook keeps them,
    then shard 0's step hands all n, stacked on axis 0, to
    ``CompressedMean``; its metrics are shard 0's."""
    hook = CompressedMean("data", mesh)
    if not mesh.local:
        fn = make_train_step(cfg, compress_grads=hook, **STEP)
        params, _, m = fn(params, adamw_init(params), batch)
        return params, m
    n = mesh.size("data")
    rows = batch["tokens"].shape[0] // n
    shards = [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
              for i in range(n)]
    kept = []

    def keep(grads):
        kept.append(tree_map(torch.clone, grads))
        return grads
    for shard in shards[1:]:
        copy = tree_map(torch.clone, params)
        make_train_step(cfg, compress_grads=keep, **STEP)(
            copy, adamw_init(copy), shard)
    fn = make_train_step(cfg, compress_grads=lambda g: hook(tree_map(
        lambda *s: torch.stack(s), g, *kept)), **STEP)
    params, _, m = fn(params, adamw_init(params), shards[0])
    return params, m


def dp_rank(mesh):
    """A rank of the gloo group: its half of the batch. → the masters
    after the step, by path."""
    torch.set_num_threads(1)
    data = Mesh(("data",), {"data": mesh.size("model")}, mesh.group)
    cfg, params, batch = setup()
    r, n = data.rank("data"), BATCH // WORLD
    params, _ = dp_step(cfg, params, {k: v[r * n:(r + 1) * n]
                                      for k, v in batch.items()}, data)
    return dict(flatten_with_path(params))
