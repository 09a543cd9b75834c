"""Asynchronous copy-out of the per-epoch checkpoint trees (counterpart of
the JAX package's core/hostcopy.py).

The training loops checkpoint their state (the DoRA tree and AdamW's
moments, or the ViT's parameters and momentum) every epoch. Copying those
tensors to the host right before the disk write makes the copy wait behind
the eval and RSA work queued after the training steps.
``prefetch_to_host`` starts the copies as soon as the training steps are
queued: each CUDA leaf is copied into pinned host memory with
``non_blocking=True`` on a side stream that first waits on an event
recorded on the current stream, so the copy runs beside the work queued
after it. ``get()`` on the returned handle waits for that copy alone and
gives the tree with numpy leaves.

Values and dtypes are unchanged. A CPU tensor is already where the caller
wants it: its ``get()`` gives a numpy copy and nothing else happens. Leaves
that are not tensors (numpy arrays, numbers, None) pass through as they are.
The caller must not update a prefetched tensor in place before ``get()``.
"""
from __future__ import annotations

import torch


def _map(tree, fn):
    """`tree` with `fn` applied to every leaf (dicts, lists and tuples are
    containers; a namedtuple keeps its type)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


class HostCopy:
    """One tree's copy-out: ``get()`` waits for the copies in flight and
    returns the tree with every tensor leaf as a numpy array. Built directly
    on a tree (no copy in flight), ``get()`` copies synchronously."""

    def __init__(self, tree, done: torch.cuda.Event | None = None,
                 pinned: frozenset = frozenset()):
        self._tree = tree
        self._done = done
        self._pinned = pinned    # ids of the pinned copies made here

    def get(self):
        if self._done is not None:
            self._done.synchronize()

        def leaf(x):
            if not isinstance(x, torch.Tensor):
                return x
            if id(x) in self._pinned:
                return x.numpy()
            return x.detach().cpu().numpy().copy()
        return _map(self._tree, leaf)


def prefetch_to_host(*trees) -> list[HostCopy]:
    """Start the copy of every CUDA tensor leaf of `trees` to pinned host
    memory; one HostCopy a tree, in order."""
    out = []
    for tree in trees:
        leaves = []
        _map(tree, lambda x: leaves.append(x) if isinstance(
            x, torch.Tensor) and x.is_cuda else None)
        if not leaves:
            out.append(HostCopy(tree))
            continue
        device = leaves[0].device
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
        side = torch.cuda.Stream(device)
        side.wait_event(ready)
        copies = {}
        with torch.cuda.stream(side):
            for x in leaves:
                dst = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                dst.copy_(x.detach(), non_blocking=True)
                # the source must outlive the copy on the side stream
                x.record_stream(side)
                copies[id(x)] = dst
        done = torch.cuda.Event()
        done.record(side)
        out.append(HostCopy(
            _map(tree, lambda x: copies.get(id(x), x)
                 if isinstance(x, torch.Tensor) else x), done,
            frozenset(id(c) for c in copies.values())))
    return out
