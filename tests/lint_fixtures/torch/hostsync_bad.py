"""Seeded host-sync violations of the port (blades-lint fixture, never
imported).  Scanned only when the test hands HostSyncPass this path as
its module list (the real pass scans the port's round modules)."""
import numpy as np
import torch


def leaky_round(updates, mask, event):
    agg = updates.mean(0)
    norm = float(torch.linalg.norm(agg))  # BAD: float() of a tensor
    count = int(mask.sum())  # BAD: int() of a reduction
    if bool(mask.any()):  # BAD: bool() of a reduction
        pass
    scalar = agg.sum().item()  # BAD: .item()
    listed = agg.tolist()  # BAD: .tolist()
    host = agg.cpu()  # BAD: .cpu()
    arr = host.numpy()  # BAD: .numpy()
    moved = agg.to("cpu")  # BAD: .to("cpu")
    kept = agg.to(device="cpu", dtype=torch.float64)  # BAD: keyword form
    fetched = np.asarray(updates)  # BAD: numpy conversion
    copied = np.array(updates)  # BAD: numpy conversion
    torch.cuda.synchronize()  # BAD: drains the queue
    event.synchronize()  # BAD: waits on the host
    idx = mask.nonzero()  # BAD: data-dependent shape
    idx2 = torch.nonzero(mask)  # BAD: data-dependent shape
    sel = torch.masked_select(updates, mask[:, None])  # BAD
    uniq = torch.unique(mask)  # BAD: data-dependent shape
    return (norm, count, scalar, listed, arr, moved, kept, fetched, copied,
            idx, idx2, sel, uniq)
