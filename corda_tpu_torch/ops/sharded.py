"""Multi-device sharding of the batched Ed25519 verify: per-device launches.

Counterpart of ``corda_tpu/ops/sharded.py``. Signature verification is
embarrassingly parallel (reference: docs/source/whitepaper/
corda-technical-whitepaper.tex:1597-1604): every lane is an independent
signature, so the batch axis -- the minor axis of every (8, N) word
array -- splits across devices with no communication on the verify path.

The reference shard_maps its verify graph over a 1-D ``jax.sharding.Mesh``.
The port has no shard_map: a mesh here is a tuple of ``torch.device``s.
The batch is padded to a multiple of the device count
(:func:`pad_to_devices`) and cut into equal column slices; each device gets
its slice's words and runs one launch of each kernel on it
(``sha512_challenge_cuda`` then ``ed25519_verify_cuda``, or their plain
PyTorch versions on CPU devices), on that device's current stream. Every
slice is launched before any result is read, so there is no host sync
between slices; the masks are then gathered in mesh order. Padded lanes
are never visible to the caller.

What differs from the reference besides the mechanism: the kernels take
any N, so the port pads only to a multiple of the device count, not to the
bucket ladder (``pick_bucket``); with one device nothing is padded and the
path is exactly ``TorchVerifier``'s (one launch of each kernel, the same
copies). A mesh asked to be wider than the host's devices raises
(``make_mesh``); nothing falls back to the host tier.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ed25519 as ted

__all__ = ["make_mesh", "sharded_verify_hashed_fn",
           "verify_batch_sharded", "pad_to_devices",
           "pack_batch_sharded", "dispatch_packed", "PackedShardedBatch"]


def make_mesh(n_devices: int | None = None,
              devices=None) -> tuple[torch.device, ...]:
    """A 1-D mesh: the first ``n_devices`` CUDA devices (all if None), or
    the explicit ``devices`` (the CPU tests pass ``[torch.device("cpu")] *
    8``). Raises when the host has fewer CUDA devices than asked for."""
    if devices is None:
        from . import require_cuda

        require_cuda("cuda")
        have = torch.cuda.device_count()
        if n_devices is not None and have < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {have}: a mesh can only "
                "span the host's own cards")
        devices = [torch.device("cuda", i) for i in range(n_devices or have)]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def pad_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= max(n, n_devices)."""
    return -(-max(n, 1) // n_devices) * n_devices


def _place(arrays, mesh) -> list[tuple[torch.Tensor, ...]]:
    """Four (8, N) uint32 word arrays -> each device's column slice, as
    int32 tensors on that device. N must be a multiple of the mesh size."""
    n = arrays[0].shape[-1]
    if n % len(mesh):
        raise ValueError(f"batch {n} is not a multiple of the mesh size "
                         f"{len(mesh)}: pad it with pad_to_devices")
    per = n // len(mesh)
    return [tuple(ted.words_to_tensor(w[:, k * per:(k + 1) * per], dev)
                  for w in arrays)
            for k, dev in enumerate(mesh)]


def _launch(graph_fn, placed) -> list[torch.Tensor]:
    """Run ``graph_fn`` on every device's slice; nothing waits for a
    device until every slice is launched."""
    return [graph_fn(*slice_) for slice_ in placed]


def _gather(outs) -> np.ndarray:
    """The per-device masks, read back in mesh order: bool (N,)."""
    if len(outs) == 1:
        return outs[0].cpu().numpy()
    return np.concatenate([o.cpu().numpy() for o in outs])


def sharded_verify_hashed_fn(mesh):
    """The twin of ``ed25519.verify_arrays_hashed`` over ``mesh``: (8, N)
    uint32 word arrays (A, R, S, M) with the batch axis split across the
    devices, each device hashing its slice's challenge (32-byte messages)
    and verifying it; N must be a multiple of the mesh size (use
    :func:`pad_to_devices`)."""
    return lambda *arrays: _gather(_launch(ted.verify_arrays_hashed,
                                           _place(arrays, mesh)))


class PackedShardedBatch:
    """Word slices already on their devices, awaiting the launches.

    The pack half (host: filter, pack the words, copy each slice to its
    device) and the dispatch half (the launches and the gather) are split
    so a pipelined caller -- the sidecar's depth-2 executor -- can pack
    batch N+1 while batch N runs."""

    __slots__ = ("n", "good", "arrays", "fn", "bucket", "n_devices")

    def __init__(self, n, good, arrays, fn, bucket, n_devices):
        self.n = n                  # total lanes requested (incl. malformed)
        self.good = good            # indices packed into the arrays
        self.arrays = arrays        # per device: four (8, bucket / D) words
        self.fn = fn                # the per-device graph (verify[_hashed])
        self.bucket = bucket        # lanes dispatched, a multiple of D
        self.n_devices = n_devices

    @property
    def pad_lanes(self) -> int:
        """Lanes dispatched that carry no real signature (the round-up to
        a multiple of the device count) -- the waste the stats attribute."""
        return self.bucket - len(self.good)


def pack_batch_sharded(pubkeys, msgs, sigs,
                       mesh) -> "PackedShardedBatch | None":
    """Host half of the sharded verify: filter malformed lanes, pad the
    well-formed count to a multiple of the mesh size, pack the words
    (device-hashed when every message is 32 bytes) and copy each device's
    slice to it. Returns None when no lane is well-formed (the caller
    answers all-False without a launch)."""
    n = len(sigs)
    good = [i for i in range(n)
            if len(pubkeys[i]) == 32 and len(sigs[i]) == 64]
    if not good:
        return None
    if len(good) < n:
        pubkeys = [pubkeys[i] for i in good]
        msgs = [msgs[i] for i in good]
        sigs = [sigs[i] for i in good]
    bucket = pad_to_devices(len(good), len(mesh))
    fn, arrays, _ = ted._precompute_auto(pubkeys, msgs, sigs, bucket)
    return PackedShardedBatch(n, good, _place(arrays, mesh), fn, bucket,
                              len(mesh))


def dispatch_packed(packed: PackedShardedBatch) -> np.ndarray:
    """Device half: launch every slice, gather, and scatter lane results
    back to the caller's index space (bool[packed.n]; padded lanes are
    dropped)."""
    ok = np.zeros(packed.n, bool)
    lanes = _gather(_launch(packed.fn, packed.arrays))
    ok[packed.good] = lanes[:len(packed.good)]
    return ok


def verify_batch_sharded(pubkeys, msgs, sigs, mesh) -> np.ndarray:
    """End-to-end sharded verify: bool[len(sigs)], malformed inputs reject.

    Host packing and path dispatch are shared with the single-device tier:
    all-32-byte messages (tx ids) hash on the device; the batch is padded
    to a multiple of the mesh size so every device gets an equal slice.
    """
    packed = pack_batch_sharded(pubkeys, msgs, sigs, mesh)
    if packed is None:
        return np.zeros(len(sigs), bool)
    return dispatch_packed(packed)
