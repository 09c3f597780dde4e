"""Clean twin of hostsync_bad.py: the round stays on the card; the one
fetch it needs carries a pragma with its reason."""
import numpy as np
import torch


def clean_round(updates, mask, device, n_clients):
    agg = torch.where(mask[:, None], updates, 0.0).sum(0)
    count = mask.sum()  # stays a tensor
    moved = agg.to(device, non_blocking=True)  # not the CPU by name
    width = int(updates.shape[1])  # a Python int, not a tensor
    scale = float(n_clients)  # a Python number
    ids = np.unique(np.arange(n_clients))  # host numpy
    where = np.nonzero(ids > 1)[0]  # host numpy
    loss = agg.sum().item()  # blades-lint: disable=host-sync — fixture: the once-per-round flush point
    return agg, count, moved, width, scale, ids, where, loss
