"""Fully sharded (ZeRO-3 / FSDP) GPT pre-training on horovod_tpu_torch
(PyTorch, and CUDA on a card): ``examples/fsdp_gpt.py`` flag for flag.

``hvd.fsdp_train_step`` keeps the parameters and the AdamW moments as
1/N flat shards between steps, so each rank persistently holds ``(1 +
2 moments)/N`` of the model: one all-gather rebuilds the parameters for
the forward and backward (``torch.func.functional_call`` on them), one
reduce-scatter takes the gradients to the shards.  The weights are drawn
from seed 0; each rank trains on its rows of the global batch.

Run on one rank per process, on the CPU (gloo)::

    for r in 0 1; do python examples/torch_fsdp_gpt.py --device cpu --steps 5 \
        --init-method file:///tmp/fsdp_store --rank $r --world-size 2 & done; wait

and on cards without ``--device cpu``.  Without a card, and without
``--device cpu``, it prints one JSON line saying so and exits with 1.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.func import functional_call

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models.transformer import (  # noqa: E402
    gpt_small,
    gpt_tiny,
    token_cross_entropy,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch-per-chip", type=int, default=2)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--small", action="store_true",
                        help="124M GPT-2-small instead of tiny")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--init-method", default=None,
                        help="torch.distributed rendezvous, e.g. file:///tmp/store")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--world-size", type=int, default=None)
    args = parser.parse_args(argv)
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
    n, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    build = gpt_small if args.small else gpt_tiny
    model = build(attn_impl="full", max_len=args.seq, seed=0, device=dev)
    cfg = model.cfg

    b = args.batch_per_chip * n
    rng = np.random.RandomState(0)
    data = rng.randint(0, cfg.vocab_size, (64, args.seq + 1)).astype(np.int64)

    def loss_fn(params, batch):
        toks, tgt = batch[:, :-1], batch[:, 1:]
        logits, aux = functional_call(model, params, (toks,))
        return token_cross_entropy(logits, tgt) + 0.01 * aux

    def local(rows):
        mine = rows[rank * args.batch_per_chip:(rank + 1) * args.batch_per_chip]
        return torch.from_numpy(np.ascontiguousarray(mine)).to(dev)

    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    # The JAX example first checks the step with its exchange IR on and off
    # (bitwise); the IR is not ported (ROADMAP Queue A entry A12 (rest)).
    step = hvd.fsdp_train_step(
        loss_fn, lambda p: torch.optim.AdamW(p, lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
                                             weight_decay=1e-4))
    pshards, opt_state = step.init(params)
    del params
    model.to("meta")  # the full copy is no longer needed: it lives sharded now

    shard_elems = pshards.numel()
    if rank == 0:
        print(f"params {n_params/1e6:.1f}M; per-chip shard "
              f"{shard_elems/1e6:.2f}M elems "
              f"(x3 with adam moments) vs {n_params/1e6:.1f}M replicated", flush=True)

    for i in range(args.steps):
        lo = (i * b) % (len(data) - b + 1)
        pshards, opt_state, loss = step(pshards, opt_state, local(data[lo:lo + b]))
        if rank == 0 and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:3d}  loss {float(loss):.4f}", flush=True)

    # Eval: re-materialize the full parameters once.
    full = step.gather(pshards)
    with torch.no_grad():
        logits, _ = functional_call(model, full,
                                    (torch.from_numpy(data[:1, :args.seq]).to(dev),))
    if rank == 0:
        print("gathered eval logits:", tuple(logits.shape), flush=True)


if __name__ == "__main__":
    main()
