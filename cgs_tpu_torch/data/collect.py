"""Dataset collection (port of `cgs_tpu/data/collect.py:22-239`;
reference main.py:1272-1458).

The trajectory filters and labelling are pure numpy functions, copied
as they are. The gzip-pickle cache `(X, Y, I)`, its filename scheme
(main.py:1277-1284) and the sha256 sidecar are the JAX package's, so a
cache written by either package loads in the other. The MineRL
download and iteration run only where `minerl` is importable.
`clean_data` is the `-cleaned` chunking that `--trainasvis` reads.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from cgs_tpu_torch.ops.discount import build_label_matrix


def trunk_filter(pov: np.ndarray, reward: np.ndarray):
    """Drop frames within 35 steps *after* a reward — the tree-crown
    chopping frames (main.py:1324-1327). Keeps frame i iff no reward
    occurred in (i-35, i)."""
    keep = np.ones(len(reward), bool)
    for i in range(1, len(reward)):
        keep[i] = reward[max(0, i - 35):i].sum() == 0
    return pov[keep], reward[keep]


def begin_filter(pov: np.ndarray, reward: np.ndarray,
                 max_prefix: int = 1000):
    """Keep only the prefix up to (and including) the first reward
    (main.py:1317-1323). Returns None if that prefix exceeds
    max_prefix frames (episode skipped, main.py:1320-1321)."""
    if reward.any():
        add = int(np.argmax(reward > 0)) + 1
        if add > max_prefix:
            return None
        return pov[:add], reward[:add]
    # reference quirk: without any reward it reuses the previous `add`;
    # we keep the full episode (the defensible reading) — documented
    # deviation from an uninitialized-variable bug (main.py:1319).
    return pov, reward


def label_episode(reward: np.ndarray, gammas=(0.98, 0.97, 0.96, 0.95),
                  ) -> np.ndarray:
    """(7, T) label matrix: row 0 binary reward, rows 1-4 discounted
    (main.py:1331-1346)."""
    return build_label_matrix(reward.astype(np.float32), gammas)


def cache_path(datadir: str, envname: str, mode: str, datasize: int,
               gammas: str) -> str:
    """Reference cache filename scheme (main.py:1277)."""
    return os.path.join(datadir,
                        f"{envname}-{mode}-{datasize}-[{gammas}].pickle")


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        for chunk in iter(lambda: fp.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_cache(path: str):
    """Load a gzip-pickle cache, verifying the sha256 sidecar when one
    exists. Reference-written caches without a sidecar load as-is."""
    sidecar = path + ".sha256"
    if os.path.exists(sidecar):
        with open(sidecar) as fp:
            expect = fp.read().strip()
        actual = _digest(path)
        if actual != expect:
            raise RuntimeError(
                f"dataset cache corrupted: {path} sha256 {actual} != "
                f"recorded {expect}; delete the cache to regenerate")
    with gzip.open(path, "rb") as fp:
        return pickle.load(fp)


def save_cache(path: str, x, y, i) -> None:
    """Gzip-pickle + sha256 sidecar, published atomically: data to a
    per-process temp name, sidecar first, then rename, so a crash
    mid-save never leaves a truncated cache that a later run accepts,
    and processes that write the same cache at once never mix their
    bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with gzip.GzipFile(tmp, "wb") as fp:
        pickle.dump((x, y, i), fp)
    with open(path + ".sha256", "w") as fp:
        fp.write(_digest(tmp))
    os.replace(tmp, path)


def collect_data(cfg, datadir: str = "runs/data/straight/",
                 write: bool = True,
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(X, Y, I) triple per the reference contract (main.py:1272-1359):
    X uint8 (N,64,64,3), Y float32 (7,N), I uint16.

    Resolution order: gzip cache -> synthetic fixture (if
    cfg.synthetic_data) -> MineRL download/iteration. write=False
    collects without writing the cache (the Handler's `primary`)."""
    # the synthetic fixture gets its own cache namespace, so it never
    # shadows a reference-format cache or vice versa
    variant = cfg.synthetic_variant
    syn_ns = ("synthetic" if variant == "easy"
              else f"synthetic{variant}")
    envname = f"{syn_ns}-{cfg.envname}" if cfg.synthetic_data \
        else cfg.envname
    path = cache_path(datadir, envname, cfg.datamode, cfg.datasize,
                      cfg.gammas)
    if os.path.exists(path):
        print(f"loading existing dataset cache {path}")
        return load_cache(path)

    size = cfg.datasize + cfg.testsize
    gammas = tuple(float(g) for g in cfg.gammas.split("-"))
    if cfg.synthetic_data:
        from cgs_tpu_torch.data.synthetic import synthetic_dataset
        x, y, i = synthetic_dataset(size, seed=cfg.seed, gammas=gammas,
                                    variant=variant)
        if write:
            save_cache(path, x, y, i)
        return x, y, i

    return _collect_minerl(cfg, size, path, gammas, write)


def _collect_minerl(cfg, size: int, path: str, gammas, write: bool):
    """MineRL trajectory sweep (main.py:1287-1350)."""
    try:
        import minerl
    except ImportError as e:
        raise RuntimeError(
            "minerl is not installed and no dataset cache exists at "
            f"{path}. Use -synthetic_data for the bundled fixture, or "
            "provide a reference-format cache.") from e

    root = os.getenv("MINERL_DATA_ROOT", "data/")
    envid = f"MineRL{cfg.envname}VectorObf-v0"
    if not os.path.exists(os.path.join(root, envid)):
        minerl.data.download(root, experiment=envid)
    data = minerl.data.make(envid, data_dir=root,
                            num_workers=cfg.workers[0],
                            worker_batch_size=cfg.workers[1])

    X = np.zeros((size, 64, 64, 3), np.uint8)
    Y = np.zeros((7, size), np.float32)
    I = np.zeros(size, np.uint16)
    runidx = 0
    for name in data.get_trajectory_names():
        steps = list(data.load_data(name))
        if not steps:
            # a truncated recording yields zero steps; skip it
            print(f"skipping empty trajectory {name}")
            continue
        state, _, reward, _, _ = zip(*steps)
        reward = np.asarray(reward, dtype=np.float32)
        pov = np.stack([s["pov"] for s in state])
        if cfg.datamode == "begin":
            res = begin_filter(pov, reward)
            if res is None:
                continue
            pov, reward = res
        elif cfg.datamode == "trunk":
            pov, reward = trunk_filter(pov, reward)
        add = min(size - runidx, len(pov))
        reward = (reward[:add] > 0).astype(np.float32)
        X[runidx:runidx + add] = pov[:add]
        Y[:, runidx:runidx + add] = label_episode(reward, gammas)[:, :add]
        I[runidx:runidx + add] = np.arange(len(pov))[:add]
        runidx += add
        if runidx >= size:
            break
    if write:
        save_cache(path, X[:runidx], Y[:, :runidx], I[:runidx])
    return X[:runidx], Y[:, :runidx], I[:runidx]


def clean_data(cfg, datadir: str = "train/data/straight/",
               x: Optional[np.ndarray] = None,
               y: Optional[np.ndarray] = None,
               i: Optional[np.ndarray] = None, write: bool = True):
    """Reward-event "chop" chunking (main.py:1361-1458): dedupe rewards
    closer than 100 frames, shift chops back by 20, take the 100-frame
    chunk ending at each chop, re-label the last 5 frames as reward.
    Cached as `{datadir}/{[synthetic-]datasize}-clean.pickle`, the JAX
    package's name and format; write=False skips the cache."""
    chunklen = 100
    min_delta = chunklen
    shift = 20
    # the collect_data namespace rule: fixture and real cleaned data
    # never shadow each other
    stem = f"synthetic-{cfg.datasize}" if cfg.synthetic_data \
        else f"{cfg.datasize}"
    path = os.path.join(datadir, f"{stem}-clean.pickle")
    if os.path.exists(path):
        return load_cache(path)

    if x is None:
        x, y, i = collect_data(cfg, write=write)
    yrow = y[0]

    chops = np.nonzero(yrow)[0]
    if len(chops) == 0:
        raise RuntimeError("clean_data: dataset contains no rewards")
    choptimes = i[chops].astype(np.int64)
    deltas = choptimes[1:] - choptimes[:-1]
    accepted = (deltas > min_delta) | (deltas < 0)
    clean_chops = np.concatenate((chops[:1], chops[1:][accepted]))

    shift_chops = clean_chops[i[clean_chops] >= shift] - shift
    chunk_chops = shift_chops[i[shift_chops] >= chunklen]
    clean_idxs = np.concatenate(
        [1 + np.arange(c - chunklen, c) for c in chunk_chops])
    yrow = yrow.copy()
    for k in range(5):
        yrow[chunk_chops - k] = 1

    out = (x[clean_idxs], yrow[clean_idxs], i[clean_idxs])
    if write:
        save_cache(path, *out)
    return out
