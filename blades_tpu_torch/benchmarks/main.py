"""Plain centralized training (counterpart of
``blades_tpu/benchmarks/main.py``): one model on one dataset's pooled
training shard, SGD with momentum, an epoch loop with the test accuracy.
The sanity baseline that says a model / dataset pair learns at all before
the federation around it is debugged.

    python -m blades_tpu_torch.benchmarks.main --model resnet10 \\
        --dataset cifar10 --epochs 5 --batch-size 128

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.func import functional_call

from blades_tpu_torch.device import resolve_device
from blades_tpu_torch.obs.trace import now


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="centralized training baseline")
    p.add_argument("--model", default="resnet10")
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    from blades_tpu_torch.core import TaskSpec
    from blades_tpu_torch.data.datasets import DatasetCatalog

    dev = resolve_device(args.device)
    ds = DatasetCatalog.get_dataset(args.dataset, num_clients=1)
    n = int(ds.train.lengths[0])
    x = torch.from_numpy(np.ascontiguousarray(ds.train.x[0, :n])).to(dev)
    y = torch.from_numpy(ds.train.y[0, :n]).long().to(dev)
    task = TaskSpec(
        model=args.model, num_classes=ds.num_classes,
        input_shape=ds.input_shape, lr=args.lr, momentum=args.momentum,
        compute_dtype="bfloat16" if args.bf16 else None).build()
    params = task.init_params(torch.Generator().manual_seed(args.seed),
                              device=dev)
    params = {k: v.requires_grad_() for k, v in params.items()}
    opt = torch.optim.SGD(params.values(), lr=args.lr,
                          momentum=args.momentum)
    task.model.to(dev)
    tx = torch.from_numpy(np.ascontiguousarray(ds.test_x)).to(dev)
    ty = torch.from_numpy(ds.test_y).long().to(dev)

    def accuracy() -> float:
        hits = 0
        with torch.no_grad():
            for i in range(0, len(ty), 1024):
                logits = functional_call(task.model, params,
                                         (tx[i:i + 1024].float(),))
                hits += int((logits.argmax(-1) == ty[i:i + 1024]).sum())
        return hits / max(len(ty), 1)

    steps = n // args.batch_size
    rng = np.random.default_rng(args.seed)
    for epoch in range(args.epochs):
        perm = torch.from_numpy(
            rng.permutation(n)[: steps * args.batch_size]).to(dev)
        t0, tot = now(), 0.0
        for i in range(steps):
            idx = perm[i * args.batch_size:(i + 1) * args.batch_size]
            loss = task.loss_fn(params, x[idx], y[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot += float(loss.detach())
        print(f"epoch {epoch}: loss={tot / max(steps, 1):.4f} "
              f"test_acc={accuracy():.4f} ({now() - t0:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
