"""GPT pre-training with hybrid parallelism on horovod_tpu_torch (PyTorch,
and CUDA on a card): ``examples/gpt_pretrain.py`` flag for flag.

A GPT language model trained over a ``dp x sp x tp`` mesh of ranks
(``parallel.make_mesh``): ring attention (``--attn ring``) passing key
and value blocks around the ``sp`` ranks, or Ulysses (``--attn
ulysses``) re-sharding heads against positions with two all-to-alls;
column/row tensor parallelism over ``tp``; the per-parameter gradient
rule of ``parallel.sync_gradients``; flash attention (kernel B2) where
the sequence is not sharded (``--attn flash``).  The same AdamW (betas
0.9 / 0.95, weight decay 0.1) and the same loop: backward,
``sync_gradients`` with ``param_shard_axes``, update, and the loss
averaged over every mesh axis (``utils.benchmarks.build_hybrid_lm_step``;
AdamW is ``capturable`` on a card, and the step runs eagerly).

Run on one rank per process, ``dp * sp * tp`` processes, for example on
the CPU (gloo)::

    for r in 0 1 2 3; do python examples/torch_gpt_pretrain.py --device cpu \
        --dp 2 --tp 2 --attn flash --steps 5 --init-method file:///tmp/gpt_store \
        --rank $r --world-size 4 & done; wait

and on four cards without ``--device cpu``.  Without a card, and without
``--device cpu``, it prints one JSON line saying so and exits with 1.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.data.packing import pack_documents, packing_efficiency  # noqa: E402
from horovod_tpu_torch.models import transformer as tt  # noqa: E402
from horovod_tpu_torch.parallel import make_mesh  # noqa: E402
from horovod_tpu_torch.utils.benchmarks import build_hybrid_lm_step  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch-per-dp", type=int, default=2)
    parser.add_argument("--seq-per-sp", type=int, default=128)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--small", action="store_true",
                        help="124M GPT-2-small config instead of tiny")
    parser.add_argument("--attn", default="ring",
                        choices=["ring", "ulysses", "flash", "full"])
    parser.add_argument("--remat", action="store_true",
                        help="recompute each block in the backward (long-context "
                        "activation memory)")
    parser.add_argument("--packed", action="store_true",
                        help="sequence packing: variable-length documents share "
                        "fixed rows under segment-id attention masking (requires "
                        "--attn flash|full, --sp 1)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--init-method", default=None,
                        help="torch.distributed rendezvous, e.g. file:///tmp/store")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--world-size", type=int, default=None)
    args = parser.parse_args(argv)
    if args.packed and (args.sp > 1 or args.attn not in ("flash", "full")):
        raise SystemExit(
            "--packed requires --sp 1 and --attn flash|full (packed rows "
            "are whole by construction; see docs/parallelism.md)"
        )
    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device found; pass "
                          "--device cpu to run on the CPU"}), flush=True)
        sys.exit(1)
    hvd.init(args.device, init_method=args.init_method, rank=args.rank,
             size=args.world_size)
    try:
        run(args)
    finally:
        hvd.shutdown()


def run(args):
    mesh = make_mesh(dp=args.dp, sp=args.sp, tp=args.tp)
    try:
        train(args, mesh)
    finally:
        mesh.shutdown()


def train(args, mesh):
    dev = hvd.device()
    build = tt.gpt_small if args.small else tt.gpt_tiny
    model = build(attn_impl=args.attn, max_len=args.seq_per_sp * args.sp, seed=0,
                  device=dev, mesh=mesh, remat=args.remat)
    cfg = model.cfg
    b = args.batch_per_dp * args.dp
    t = args.seq_per_sp * args.sp
    rng = np.random.RandomState(0)
    # Synthetic corpus: next-token prediction on random data.
    data = rng.randint(0, cfg.vocab_size, (64, t + 1)).astype(np.int32)
    if args.packed:
        docs = [
            rng.randint(
                0, cfg.vocab_size,
                int(np.clip(rng.lognormal(np.log(t / 3.0), 0.7), 8, t)),
            ).astype(np.int32)
            for _ in range(256)
        ]
        ptoks, psegs = pack_documents(docs, t)
        if hvd.rank() == 0:
            print(f"packed {len(docs)} docs into {len(ptoks)} rows, "
                  f"efficiency {packing_efficiency(psegs):.2f}")
    step, _ = build_hybrid_lm_step(model, mesh, packed=args.packed, lr=args.lr)
    # This rank's block of the batch: rows over dp, positions over sp.
    rows = slice(mesh.axis_index("dp") * args.batch_per_dp,
                 (mesh.axis_index("dp") + 1) * args.batch_per_dp)
    cols = slice(mesh.axis_index("sp") * args.seq_per_sp,
                 (mesh.axis_index("sp") + 1) * args.seq_per_sp)

    def local(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows, cols])).long().to(dev)

    losses = []
    t0 = time.time()
    for _ in range(args.steps):
        if args.packed:
            pick = rng.randint(0, len(ptoks), b)
            loss = step(local(ptoks[pick]), local(psegs[pick]))
        else:
            pick = rng.randint(0, len(data), b)
            loss = step(local(data[pick, :t]), local(data[pick, 1:t + 1]))
        losses.append(float(loss))
    dt = time.time() - t0
    if hvd.rank() == 0:
        tok_s = args.steps * b * t / dt
        print(f"attn={args.attn} mesh dp{args.dp}/sp{args.sp}/tp{args.tp}: "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
              f"{tok_s:,.0f} tok/s")


if __name__ == "__main__":
    main()
