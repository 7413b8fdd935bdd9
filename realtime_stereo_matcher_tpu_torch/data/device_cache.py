"""Device-resident dataset: the training set lives in device memory, steps
ship indices (port of ``realtime_stereo_matcher_tpu/data/device_cache.py``).

The whole training set is uploaded once at start-up and each step sends a
(B,) index vector instead of a raw batch; the batch is gathered on the card
and augmented there (``data/device_augment.py``).  In a data-parallel run
each rank holds only its block of the scenes (``ShardedResidentScenes``).
Layout per scene:

* left/right images as uint8 (N, H, W, 3), the generator's output;
* disparity as 16-bit fixed point: the synthetic set at 1/512 px
  (``DISP_FIXED_POINT``; max_disp 64 -> 32768 < 65535), any other dataset
  at 1/128 px (``GENERIC_FIXED_POINT``, disparities to 511 px) with invalid
  pixels stored as ``SENTINEL``, which decodes to flow -1024 so every
  validity rule downstream (|flow| < 512 in device_augment, |flow| < 700 in
  SequenceLoss) rejects it.  The 16-bit words are held on the device as
  ``torch.int16`` bit patterns (the same bits as numpy's uint16, which few
  torch ops take) and decoded by ``fetch_scene_batch``.

4000 synthetic scenes at 320 x 448 take 4.59 GB.  ``pack_synthetic``
memoizes its packs on disk (uncompressed ``.npz``) keyed by the generator
parameters and a hash of the generator's source, in a directory of the checkout by default (``_runs/``, which
git ignores), so a repeated run skips the scene generation.  Its key names
the port: the port's numpy scenes can differ from the JAX package's cv2
ones by one level on a few pixels, so the two packages never share a pack.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from pathlib import Path

import numpy as np
import torch

from realtime_stereo_matcher_tpu_torch.utils.spans import span

DISP_FIXED_POINT = 512.0  # synthetic-set disparity quanta: 1/512 px
GENERIC_FIXED_POINT = 128.0  # any other dataset: 1/128 px, to 511 px
SENTINEL = np.uint16(65535)
_SENTINEL_FLOW = 1024.0
# the port's scene cache, inside the checkout
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / "_runs" / "scene_cache"


def _fill_threads(n: int, fill) -> None:
    """Run ``fill(lo, hi)`` over [0, n) in contiguous chunks on up to 8
    threads (numpy releases the GIL in its loops); the first exception
    raised in a thread is raised here."""
    num_threads = min(8, os.cpu_count() or 1)
    errors: list = []

    def run(lo, hi):
        try:
            fill(lo, hi)
        except Exception as exc:  # noqa: BLE001 - raised again below
            errors.append(exc)

    chunk = (n + num_threads - 1) // num_threads
    threads = [threading.Thread(target=run,
                                args=(t * chunk, min(n, (t + 1) * chunk)))
               for t in range(num_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def cache_path(ds, cache_dir=DEFAULT_CACHE_DIR) -> Path:
    """Where :func:`pack_synthetic` keeps the pack of SyntheticStereo
    ``ds``: keyed by the generator parameters and the first 12 hex digits
    of the SHA-1 of ``data/synthetic.py`` (an edited generator never reads
    an older pack), and named for the port."""
    from realtime_stereo_matcher_tpu_torch.data import synthetic

    source = hashlib.sha1(Path(synthetic.__file__).read_bytes()).hexdigest()
    h, w = ds.image_hw
    key = (f"torch_s{ds.seed0}_n{ds.length}_{h}x{w}_d{ds.max_disp:g}"
           f"_{source[:12]}")
    return Path(cache_dir) / f"{key}.npz"


def pack_synthetic(ds, cache_dir=DEFAULT_CACHE_DIR) -> dict:
    """Materialize a SyntheticStereo dataset as packed numpy arrays.

    Returns {"img1": (N,H,W,3) u8, "img2": (N,H,W,3) u8,
    "disp_q": (N,H,W) u16}; reads/writes a disk cache keyed by the
    generator parameters (scenes are deterministic per (seed0, index)) under
    ``cache_dir``, none when it is None.
    """
    from realtime_stereo_matcher_tpu_torch.data.synthetic import make_scene

    h, w = ds.image_hw
    path = cache_path(ds, cache_dir) if cache_dir is not None else None
    if path is not None and path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in ("img1", "img2", "disp_q")}

    img1 = np.empty((ds.length, h, w, 3), np.uint8)
    img2 = np.empty((ds.length, h, w, 3), np.uint8)
    disp_q = np.empty((ds.length, h, w), np.uint16)

    def fill(lo, hi):
        for i in range(lo, hi):
            l, r, d, _ = make_scene(ds.seed0 + i, h, w, max_disp=ds.max_disp)
            img1[i] = l
            img2[i] = r
            disp_q[i] = np.round(d * DISP_FIXED_POINT).astype(np.uint16)

    _fill_threads(ds.length, fill)
    packed = {"img1": img1, "img2": img2, "disp_q": disp_q}
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        # a name of this process and thread: concurrent packers of one key
        # each write their own file, and the renames replace it whole
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.npz")
        np.savez(tmp, **packed)
        tmp.rename(path)
    logging.info("Packed %d scenes (%.2f GB)%s", ds.length,
                 (img1.nbytes * 2 + disp_q.nbytes) / 1e9,
                 f" -> {path}" if path is not None else "")
    return packed


def pack_dataset(ds, *, indices=None, max_bytes: float = 8e9) -> dict:
    """Materialize ANY uniform-shape StereoDataset as packed resident arrays.

    ``ds`` is a raw-mode (no host augmentor) dataset -- a single
    ``StereoDataset`` family or a ``ConcatDataset`` -- whose samples are
    ``(files, img1 u8, img2 u8, flow f32 (H,W,1) [negative], valid (H,W))``.
    Disparity packs as uint16 at 1/128 px with the invalid-pixel SENTINEL
    (sparse GT like KITTI needs no valid plane).

    Raises ValueError on non-uniform shapes, disparities beyond 511 px, or a
    footprint over ``max_bytes`` -- the trainer catches it and falls back to
    host streaming.

    ``indices``: pack only these dataset positions, in order (a
    data-parallel rank packs its contiguous block, ``ShardedResidentScenes``).
    """
    indices = list(indices) if indices is not None else range(len(ds))
    n = len(indices)
    _, i1, _, _, _ = ds[indices[0]]
    h, w = i1.shape[:2]
    nbytes = n * h * w * (3 + 3 + 2)
    if nbytes > max_bytes:
        raise ValueError(
            f"packed dataset {nbytes / 1e9:.2f} GB exceeds the "
            f"{max_bytes / 1e9:.0f} GB resident budget")

    img1 = np.empty((n, h, w, 3), np.uint8)
    img2 = np.empty((n, h, w, 3), np.uint8)
    disp_q = np.empty((n, h, w), np.uint16)

    def fill(lo, hi):
        for i in range(lo, hi):
            _, a, b, flow, valid = ds[indices[i]]
            if a.shape[:2] != (h, w):
                raise ValueError(
                    f"scene {i} shape {a.shape[:2]} != {(h, w)}: "
                    "resident packing needs uniform shapes")
            d = -flow[..., 0]
            if float(d.max(initial=0.0)) * GENERIC_FIXED_POINT > 65534:
                raise ValueError(
                    f"scene {i} disparity {d.max():.1f} exceeds the "
                    "511-px fixed-point range")
            img1[i] = a.astype(np.uint8)
            img2[i] = b.astype(np.uint8)
            q = np.round(np.clip(d, 0.0, None)
                         * GENERIC_FIXED_POINT).astype(np.uint16)
            q[np.asarray(valid) <= 0] = SENTINEL
            disp_q[i] = q

    _fill_threads(n, fill)
    logging.info("Packed %d scenes (%.2f GB) for device residency.",
                 n, nbytes / 1e9)
    return {"img1": img1, "img2": img2, "disp_q": disp_q,
            "fp": GENERIC_FIXED_POINT}


def fetch_scene_batch(arrays, idx, fp: float = DISP_FIXED_POINT):
    """(img1, img2, disp_q) resident tensors + (B,) indices ->
    (img1 u8 (B,H,W,3), img2 u8, flow f32 (B,H,W,1)), on their device.

    ``disp_q`` holds the 16-bit words as int16; ``fp`` is the pack's
    fixed-point scale.  SENTINEL words decode to flow -1024."""
    img1, img2, disp_q = arrays
    with span("rsm.fetch"):
        idx = idx.to(img1.device)
        q = disp_q.index_select(0, idx).to(torch.int32) & 0xFFFF
        d = torch.where(q == int(SENTINEL), _SENTINEL_FLOW,
                        q.to(torch.float32) / fp)
        return (img1.index_select(0, idx), img2.index_select(0, idx),
                -d.unsqueeze(-1))


class DeviceResidentScenes:
    """The packed dataset as tensors on ``device`` + an index-batch
    sampler."""

    def __init__(self, packed: dict, *, device):
        self.img1 = torch.from_numpy(packed["img1"]).to(device)
        self.img2 = torch.from_numpy(packed["img2"]).to(device)
        self.disp_q = torch.from_numpy(
            np.ascontiguousarray(packed["disp_q"]).view(np.int16)).to(device)
        self.length = int(packed["img1"].shape[0])
        self.image_hw = tuple(packed["img1"].shape[1:3])
        self.fp = float(packed.get("fp", DISP_FIXED_POINT))

    @property
    def arrays(self):
        return (self.img1, self.img2, self.disp_q)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays)

    def fetch(self, idx):
        """The raw batch of scenes ``idx``: :func:`fetch_scene_batch`."""
        return fetch_scene_batch(self.arrays, idx, self.fp)

    def index_batches(self, batch_size: int, *, epoch0: int = 0):
        """Infinite stream of (B,) int32 index batches (numpy): per-epoch
        shuffled permutations from ``epoch0`` on -- the JAX trainer's
        single-process stream (its seed 1234), index for index."""
        epoch = epoch0
        while True:
            rng = np.random.default_rng(1234 + epoch)
            idx = rng.permutation(self.length)
            nb = len(idx) // batch_size
            for b in range(nb):
                yield idx[b * batch_size:(b + 1) * batch_size].astype(np.int32)
            epoch += 1


class ShardedResidentScenes(DeviceResidentScenes):
    """Scene-sharded residency for data-parallel training (JAX
    ``ShardedResidentScenes``, data/device_cache.py:226-332).

    Rank r of ``world`` holds only its block of ``per_device = total //
    world`` scenes (``local_scene_range``), packed by that rank alone, so the
    ranks together hold one copy of the dataset.  Each epoch draws ``world``
    permutations of ``range(per_device)`` from ``default_rng(seed + epoch)``
    and rank r takes its ``batch_size / world`` rows of permutation r:
    LOCAL indices into its own block, fetched with no communication.  Not a
    global shuffle, but each block is a random partition of the dataset.

    ``batch_size`` is the GLOBAL batch, the config's (the loader's
    convention): the JAX package's trainer hands the same number to its
    form as the host-local batch, so its global batch grows with the
    process count (ROADMAP.md, queue 3)."""

    def __init__(self, packed_local: dict, *, device, rank: int, world: int,
                 global_length: int):
        super().__init__(packed_local, device=device)
        if global_length % world or self.length != global_length // world:
            raise ValueError(f"{self.length} local scenes are not 1/{world} "
                             f"of {global_length}")
        self.per_device = self.length
        self.global_length = global_length
        self.rank, self.world = rank, world

    @staticmethod
    def local_scene_range(total: int, rank: int,
                          world: int) -> tuple[int, int]:
        """[lo, hi) of the scenes rank ``rank`` packs: its contiguous block
        of the ``total // world * world`` scenes kept."""
        m = total // world
        return rank * m, (rank + 1) * m

    def index_batches(self, batch_size: int, *, seed: int = 1234,
                      epoch0: int = 0):
        """Infinite stream of this rank's (batch_size / world,) int32 LOCAL
        index batches, ``per_device // (batch_size / world)`` an epoch."""
        if batch_size % self.world:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{self.world} ranks")
        b = batch_size // self.world
        m = self.per_device
        epoch = epoch0
        while True:
            rng = np.random.default_rng(seed + epoch)
            # one shuffled pass over every rank's block an epoch
            perm = [rng.permutation(m) for _ in range(self.world)][self.rank]
            for k in range(m // b):
                yield perm[k * b:(k + 1) * b].astype(np.int32)
            epoch += 1
