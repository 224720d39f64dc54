"""MNIST-style data-parallel training on horovod_tpu_torch (PyTorch, and
CUDA on a card): ``examples/mnist.py`` step for step.

Run: ``python examples/torch_port_mnist.py [--epochs N]`` on a card, or
``--device cpu`` on the CPU (gloo).  Several processes: set ``RANK`` /
``WORLD_SIZE`` (``torchrun``), or give each process ``--rank``,
``--world-size`` and a shared ``--init-method`` (``file:///path``).

The data are the same synthetic MNIST-shaped images and labels as
``examples/mnist.py`` (no download); the mechanics follow the
reference's ``examples/pytorch/pytorch_mnist.py``: rank 0's initial
weights broadcast, ``DistributedOptimizer`` averaging the gradients of
every step (each bucket launched from the backward), the learning rate
scaled by the world size, the loss averaged across ranks.  Each rank
trains on its shard of every global batch.  ``--use-adasum`` combines
the gradients with Adasum (``op=hvd.Adasum``) and scales the learning
rate by ``local_size()`` instead, as ``examples/mnist.py`` does.
"""

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models import MnistCNN  # noqa: E402


def synthetic_mnist(n=8192, seed=0):
    """``examples/mnist.py``'s data: uniform images, labels derived from
    the image so the task is learnable."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 28, 28, 1).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) * 1000).astype(np.int32) % 10
    return x, y


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=64,
                        help="per-rank batch size (reference default 64)")
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--momentum", type=float, default=0.5)
    parser.add_argument("--use-adasum", action="store_true",
                        help="use Adasum gradient combining")
    parser.add_argument("--num-samples", type=int, default=8192,
                        help="synthetic dataset size (shrink for smoke tests)")
    parser.add_argument("--log-every", type=int, default=10,
                        help="print the loss every this many steps")
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
    rank, size = hvd.rank(), hvd.size()
    global_batch = args.batch_size * size

    model = MnistCNN(seed=0, device=dev)
    # reference: hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # reference: the learning rate scaled by hvd.size(); Adasum uses local_size
    lr_scale = hvd.local_size() if args.use_adasum else size
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr * lr_scale,
                        momentum=args.momentum),
        named_parameters=model.named_parameters(),
        op=hvd.Adasum if args.use_adasum else hvd.Average,
    )
    step = hvd.TrainStep(model, opt, lambda m, b: F.cross_entropy(m(b[0]), b[1]))

    X, Y = synthetic_mnist(n=args.num_samples)
    steps_per_epoch = len(X) // global_batch
    if steps_per_epoch < 1:
        raise SystemExit(
            f"--num-samples {args.num_samples} < global batch "
            f"{global_batch}; nothing to train"
        )
    loss = None
    for epoch in range(args.epochs):
        perm = np.random.RandomState(epoch).permutation(len(X))
        for i in range(steps_per_epoch):
            idx = perm[i * global_batch:(i + 1) * global_batch]
            mine = idx[rank * args.batch_size:(rank + 1) * args.batch_size]
            batch = (torch.from_numpy(X[mine]).to(dev),
                     torch.from_numpy(Y[mine]).long().to(dev))
            loss = step(batch)
            if i % args.log_every == 0 and rank == 0:
                print(f"epoch {epoch} step {i}/{steps_per_epoch} "
                      f"loss {float(loss):.7f}", flush=True)
    if rank == 0:
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"final loss: {float(loss):.7f} ({size} rank(s) on {where})",
              flush=True)


if __name__ == "__main__":
    main()
