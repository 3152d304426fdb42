"""Phase 14a of ``chip_smoke.py`` (``config/e2e/fluxd-r5.json``'s
``Trainer.run`` over two size buckets, with its checks) under several draw
orders of ``static_chunked``: which mesh of a chunk draws its timestep
order first from the generator. Both packages draw them in the iteration
order of ``set(chunk)``, which follows the process's string hashing
(PYTHONHASHSEED), so any assignment may occur in a run.

    python3 scripts/torch_chunk_orders.py [N]     # N orders, default 10

The first order is the sorted one; the others are drawn from
``np.random.default_rng(12345)``, one permutation of each bucket's four
meshes. For each it prints one line ``ORDER {...}``: the orders, whether
14a's checks passed, the mean loss over the first and the last 10 steps
of epoch 1 (``first10``, ``last10``) and of its first bucket's steps
(``bucket_first10``, ``bucket_last10``: what 14a checks), and every
step's loss of epoch 1. Needs one card; writes
``build/studies/chunk_orders.json``.
"""

import itertools
import json
import os
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.chdir(ROOT)

import chip_smoke as cs  # noqa: E402
from gnn_fluid_dynamics_tpu_torch.data import samplers  # noqa: E402
from gnn_fluid_dynamics_tpu_torch.ops import kernels  # noqa: E402
from gnn_fluid_dynamics_tpu_torch.training import trainer as trainer_mod  # noqa: E402

PERMS = list(itertools.permutations(range(4)))


class Failed(Exception):
    pass


def raise_failed(msg):
    print(f"FAIL: {msg}", flush=True)
    raise Failed(msg)


def draw_order(small, large):
    """A stand-in for the ``set`` that ``static_chunked_batches`` reads:
    a chunk's distinct meshes in the permutation ``small`` (the
    TRAIN_POINTS bucket, ids ``s*``) or ``large``."""
    def ordered(chunk):
        ids = sorted(dict.fromkeys(chunk))
        perm = PERMS[small] if ids[0].startswith("s") else PERMS[large]
        return [ids[i] for i in perm]
    return ordered


def main() -> int:
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    cs.fail = raise_failed
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    line = cs.card_line()
    valid_ds, _ = cs.valid_data(dev)
    trajs = cs.bucket_data()
    losses = []
    step = trainer_mod.Trainer.train_step_indexed

    def recording(self, state, graph, dev, ts, lrs, window, **kw):
        out = step(self, state, graph, dev, ts, lrs, window, **kw)
        losses.append((self.epoch_count, out["total_log_loss"].tolist()))
        return out

    trainer_mod.Trainer.train_step_indexed = recording
    rng = np.random.default_rng(12345)
    orders = [(0, 0)] + [tuple(int(x) for x in rng.integers(len(PERMS), size=2))
                         for _ in range(n - 1)]
    results = []
    for small, large in orders:
        samplers.set = draw_order(small, large)
        losses.clear()
        try:
            cs.bucket_training(trajs, valid_ds, line)
            ok = True
        except Failed:
            ok = False
        finally:
            del samplers.set
        w = cs.FUSED_LOSS_WINDOW
        epoch1 = [v for e, vs in losses if e == 1 for v in vs]
        bucket = losses[0][1]    # epoch 1's first call: one bucket's steps
        result = {"order_s": PERMS[small], "order_v": PERMS[large], "ok": ok,
                  "first10": float(np.mean(epoch1[:w])),
                  "last10": float(np.mean(epoch1[-w:])),
                  "bucket_first10": float(np.mean(bucket[:w])),
                  "bucket_last10": float(np.mean(bucket[-w:])),
                  "epoch1": [round(v, 4) for v in epoch1], "card": line}
        results.append(result)
        print("ORDER", json.dumps(result), flush=True)
    out = ROOT / "build" / "studies"
    out.mkdir(parents=True, exist_ok=True)
    (out / "chunk_orders.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
