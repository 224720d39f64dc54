"""Embedding training with sparse gradients on horovod_tpu_torch (PyTorch,
and CUDA on a card): ``examples/embedding_sparse.py`` flag for flag.

The reference's sparse gradient path (``tensorflow/__init__.py:95-162``)
allgathers the touched rows of an embedding table instead of allreducing
the dense table; ``torch/optimizer.py`` offers ``sparse_as_dense`` to opt
out.  Here ``nn.Embedding(sparse=True)`` makes the embedding's gradient a
sparse COO tensor, and ``DistributedOptimizer`` reduces it as an
allgather of its indices and rows (``ops/sparse.py``), then densifies it
for SGD; ``--sparse-as-dense`` densifies first and allreduces the table.

Run: ``python examples/torch_embedding_sparse.py [--sparse-as-dense]`` on
a card, or ``--device cpu``; several processes as
``examples/torch_port_mnist.py`` says.  A skip-gram-style task on
synthetic token co-occurrences (context = center + 1 or + 2).  Before
training it checks, from one state, that two steps of the sparse path
and of ``sparse_as_dense`` give the same losses (to 1e-5: the two sum the
rows in other orders).  The JAX example's check of its exchange IR on
against off waits for that IR (ROADMAP Queue A entry A12 (rest)).
"""

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402

VOCAB, DIM = 2048, 64


def synthetic_pairs(n, seed=0):
    """(center, context) pairs: context tends to be center+1 or +2 mod
    VOCAB, so the embedding geometry is learnable."""
    rng = np.random.RandomState(seed)
    center = rng.randint(0, VOCAB, n).astype(np.int64)
    context = (center + rng.choice([1, 2], n)) % VOCAB
    return center, context.astype(np.int64)


class SkipGram(torch.nn.Module):
    def __init__(self, device):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.emb = torch.nn.Embedding(VOCAB, DIM, sparse=True)
        self.out = torch.nn.Linear(DIM, VOCAB, bias=False)
        with torch.no_grad():
            self.emb.weight.copy_(torch.randn(VOCAB, DIM, generator=g) * 0.1)
            self.out.weight.copy_(torch.randn(VOCAB, DIM, generator=g) * 0.1)
        self.to(device)

    def forward(self, center):
        return self.out(self.emb(center))


def make(args, dev, sparse_as_dense):
    model = SkipGram(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=args.lr),
                                   named_parameters=model.named_parameters(),
                                   sparse_as_dense=sparse_as_dense)
    return model, opt


def step(model, opt, center, context):
    loss = F.cross_entropy(model(center), context)
    loss.backward()
    opt.step()
    opt.zero_grad()
    return hvd.allreduce(loss.detach(), op=hvd.Average)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=64, help="per-rank batch size")
    parser.add_argument("--lr", type=float, default=0.5)
    parser.add_argument("--sparse-as-dense", action="store_true",
                        help="densify before reduction (reference torch "
                        "sparse_as_dense knob)")
    parser.add_argument("--num-samples", type=int, default=65536)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--init-method", default=None,
                        help="torch.distributed rendezvous, e.g. file:///tmp/store")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--world-size", type=int, default=None)
    args = parser.parse_args(argv)
    hvd.init(args.device, init_method=args.init_method, rank=args.rank,
             size=args.world_size)
    try:
        train(args)
    finally:
        hvd.shutdown()


def train(args):
    dev = hvd.device()
    rank, n = hvd.rank(), hvd.size()
    global_batch = args.batch_size * n
    center, context = synthetic_pairs(args.num_samples)
    steps = min(args.steps, args.num_samples // global_batch)

    def batch(i):
        lo = i * global_batch + rank * args.batch_size
        return (torch.from_numpy(center[lo:lo + args.batch_size]).to(dev),
                torch.from_numpy(context[lo:lo + args.batch_size]).to(dev))

    check = []
    for dense in (False, True):
        model, opt = make(args, dev, dense)
        check.append([float(step(model, opt, *batch(i))) for i in range(2)])
    if not np.allclose(check[0], check[1], rtol=1e-5, atol=0):
        raise SystemExit(f"sparse path {check[0]} != sparse_as_dense {check[1]}")
    if rank == 0:
        print(f"sparse path == sparse_as_dense over 2 steps (rtol 1e-5): {check[0]}",
              flush=True)

    model, opt = make(args, dev, args.sparse_as_dense)
    mode = "dense" if args.sparse_as_dense else "sparse"
    for i in range(steps):
        loss = step(model, opt, *batch(i))
        if rank == 0 and (i % 50 == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {float(loss):.4f}  ({mode} reduction)", flush=True)


if __name__ == "__main__":
    main()
