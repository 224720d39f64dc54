"""Synthetic CNN throughput benchmark on horovod_tpu_torch (PyTorch, and
CUDA on a card): ``examples/synthetic_benchmark.py`` flag for flag, after
the reference's ``examples/pytorch/pytorch_synthetic_benchmark.py``.

Measures images/sec of forward + backward + gradient exchange + update
on synthetic ImageNet-shaped data.  Run: ``python
examples/torch_synthetic_benchmark.py [--model resnet50]`` on a card;
several processes as ``examples/torch_port_mnist.py`` says.  Without a
card, and without ``--device cpu``, it prints one JSON line saying so and
exits with 1: it never falls back to the CPU.  ``--sync-bn`` reduces the
BatchNorm moments across ranks (``ResNet(sync_bn=True)``);
``--use-adasum`` combines the gradients with Adasum (``op=hvd.Adasum``).
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
from horovod_tpu_torch.models import ResNet50, ResNet101  # noqa: E402
from horovod_tpu_torch.utils.benchmarks import build_dp_step  # noqa: E402

MODELS = {"resnet50": ResNet50, "resnet101": ResNet101}
NOT_PORTED = ("vgg16", "inception3")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="resnet50",
                        choices=sorted(MODELS) + list(NOT_PORTED))
    parser.add_argument("--batch-size", type=int, default=32,
                        help="per-card batch (reference default 32)")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-warmup-batches", type=int, default=10)
    parser.add_argument("--num-batches-per-iter", type=int, default=10)
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--fp16-allreduce", action="store_true")
    parser.add_argument("--sync-bn", action="store_true",
                        help="BatchNorm moments reduced across ranks")
    parser.add_argument("--use-adasum", action="store_true",
                        help="use Adasum gradient combining")
    parser.add_argument("--stem", default="conv7",
                        choices=["conv7", "space_to_depth"],
                        help="ResNet stem: space_to_depth folds the 7x7/2 "
                        "conv into a 4x4/1 conv over 2x2 blocks")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--init-method", default=None,
                        help="torch.distributed rendezvous, e.g. file:///tmp/store")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--world-size", type=int, default=None)
    args = parser.parse_args(argv)
    if args.model in NOT_PORTED:
        raise NotImplementedError(
            f"--model {args.model} is not ported to horovod_tpu_torch yet "
            "(ROADMAP Queue A item 14)"
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
    dev = hvd.device()
    rank, size = hvd.rank(), hvd.size()
    model = MODELS[args.model](num_classes=1000, dtype=torch.bfloat16,
                               stem=args.stem, seed=0, device=dev, sync_bn=args.sync_bn)
    step, _ = build_dp_step(
        hvd, model,
        compression=hvd.Compression.fp16 if args.fp16_allreduce
        else hvd.Compression.none,
        op=hvd.Adasum if args.use_adasum else hvd.Average,
    )

    global_batch = args.batch_size * size
    rng = np.random.RandomState(0)
    data = rng.rand(global_batch, args.image_size, args.image_size, 3) \
        .astype(np.float32)
    target = rng.randint(0, 1000, global_batch)
    mine = slice(rank * args.batch_size, (rank + 1) * args.batch_size)
    batch = (torch.from_numpy(data[mine]).to(dev),
             torch.from_numpy(target[mine]).long().to(dev))

    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    unit = "card" if dev.type == "cuda" else "rank"
    if rank == 0:
        print(f"Model: {args.model}, batch {args.batch_size}/{unit} x {size} "
              f"{unit}(s) on {where}; sync_bn={args.sync_bn}, "
              f"adasum={args.use_adasum}", flush=True)
    loss = None
    for _ in range(args.num_warmup_batches):
        loss = step(batch)
    if loss is not None:
        float(loss)  # a host read: waits for the device's work

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = step(batch)
        float(loss)
        ips = global_batch * args.num_batches_per_iter / (time.perf_counter() - t0)
        img_secs.append(ips)
        if rank == 0:
            print(f"Iter #{i}: {ips:.1f} img/sec total", flush=True)
    if rank == 0:
        mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
        print(f"Img/sec per {unit}: {mean / size:.1f} +- {conf / size:.1f} "
              f"({where})")
        print(f"Total img/sec on {size} {unit}(s): {mean:.1f} +- {conf:.1f} "
              f"({where})", flush=True)


if __name__ == "__main__":
    main()
