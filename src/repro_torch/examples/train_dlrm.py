"""Train a ~100M-parameter DLRM for a few hundred steps with the full
fault-tolerant runtime: checkpoint/restart, preemption handling, straggler
flagging, row-wise Adagrad on the embedding tables — the port's
counterpart of the JAX package's `examples/train_dlrm.py`, with its
configuration unchanged.

    python -m repro_torch.examples.train_dlrm [--steps 200] [--ckpt DIR]

Interrupt with Ctrl-C and re-run: it resumes from the checkpoint.

`--device cuda` (the default) runs the embedding-bag kernel forward and
its backward (`kernels.embedding_bag.EmbeddingBagFunction`) and needs a
card; `--device cpu` runs the plain gather under autograd. The tables and
their dense gradient (twice the table bytes) must fit on the device. Run
from a checkout with `src` on the path (`PYTHONPATH=src`); the default
checkpoint directory is the checkout's `build/train_dlrm_ckpt`.
"""
from __future__ import annotations

import argparse
import signal
from pathlib import Path

import torch

from repro_torch.core import EmbeddingStageConfig
from repro_torch.data import DLRMQueryStream
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.optim import (rowwise_adagrad_init, rowwise_adagrad_update,
                               sgdm_init, sgdm_update)
from repro_torch.runtime import TrainLoop, TrainLoopConfig
from repro_torch.utils import resolve_device

# ~100M params: 16 tables x 48K rows x 128 dim = 98M + MLPs
CONFIG = DLRMConfig(embedding=EmbeddingStageConfig(
    num_tables=16, rows=48_000, dim=128, pooling=20))
BATCH, HOTNESS, SEED = 64, "med_hot", 0
LR_DENSE, LR_EMB = 0.01, 0.05          # SGD momentum on the MLPs; Adagrad
DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_dlrm_ckpt"


def make_stream(cfg: DLRMConfig | None = None,
                batch_size: int = BATCH) -> DLRMQueryStream:
    """The reference example's stream over `cfg`'s tables (`CONFIG`'s
    when None)."""
    emb = (cfg or CONFIG).embedding
    return DLRMQueryStream(num_tables=emb.num_tables, rows=emb.rows,
                           pooling=emb.pooling, batch_size=batch_size,
                           dense_features=(cfg or CONFIG).dense_features,
                           hotness=HOTNESS, seed=SEED)


def train_state(model: DLRM) -> dict:
    """The reference's training state over the model's own tensors:
    `{"params": {"bottom", "top", "embedding": {"tables"}}, "opt_dense":
    SGD momentum of the MLPs, "opt_emb": row-wise Adagrad of the tables}`.
    Makes the tables require a gradient."""
    params = {"bottom": dict(model.bottom.named_parameters()),
              "top": dict(model.top.named_parameters()),
              "embedding": {"tables": model.ebc.tables.requires_grad_(True)}}
    return {"params": params,
            "opt_dense": sgdm_init({"bottom": params["bottom"],
                                    "top": params["top"]}),
            "opt_emb": rowwise_adagrad_init(params["embedding"])}


def batch_tensors(batch, device) -> tuple[torch.Tensor, ...]:
    """A `DLRMBatch`'s (dense, indices, labels) on `device`."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in (batch.dense, batch.indices, batch.labels))


def make_train_step(model: DLRM, *, lr_dense: float = LR_DENSE,
                    lr_emb: float = LR_EMB):
    """step_fn(state, batch) -> (state, loss) for `TrainLoop`, over
    `train_state(model)`. A step that raises leaves the state as it was:
    every gradient is computed before any parameter is written, and
    row-wise Adagrad, which builds the step's largest temporary (the
    squared table gradient) before its own writes, runs before SGD
    momentum, which allocates nothing once it writes."""
    def step_fn(state, batch):
        dense, idx, labels = batch_tensors(batch, model.device)
        params = state["params"]
        names = [(tower, k) for tower in ("bottom", "top")
                 for k in params[tower]]
        tables = params["embedding"]["tables"]
        loss = model.loss(dense, idx, labels)
        grads = torch.autograd.grad(
            loss, [params[t][k] for t, k in names] + [tables])
        # every gradient is in hand: from here on the step writes
        g_dense = {"bottom": {}, "top": {}}
        for (t, k), g in zip(names, grads):
            g_dense[t][k] = g
        rowwise_adagrad_update(params["embedding"], {"tables": grads[-1]},
                               state["opt_emb"], lr=lr_emb)
        sgdm_update({"bottom": params["bottom"], "top": params["top"]},
                    g_dense, state["opt_dense"], lr=lr_dense)
        return state, loss.detach()
    return step_fn


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (plain)")
    return ap.parse_args(argv)


def main(argv=None) -> TrainLoop:
    args = parse_args(argv)
    model = DLRM(CONFIG, device=resolve_device(args.device), seed=SEED)
    n = sum(p.numel() for p in model.parameters()) + model.ebc.tables.numel()
    print(f"DLRM parameters: {n/1e6:.1f}M")
    loop = TrainLoop(TrainLoopConfig(total_steps=args.steps,
                                     checkpoint_every=20, log_every=20),
                     make_train_step(model), train_state(model),
                     make_stream(), args.ckpt)
    previous = loop.install_signal_handlers()
    try:
        if loop.restore():
            print(f"resumed from step {loop.step}")
        hist = loop.run()
    finally:
        for signum, handler in previous.items():
            signal.signal(signum, handler)
    if hist:
        print(f"done: steps {hist[0].step}..{hist[-1].step}  "
              f"loss {hist[0].loss:.4f} -> {hist[-1].loss:.4f}  "
              f"stragglers={sum(h.straggler for h in hist)}")
    return loop


if __name__ == "__main__":
    main()
