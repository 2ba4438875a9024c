"""Fault-tolerant checkpoints of host state (port of `repro.checkpoint.manager`).

Guarantees, as the reference's:
  * atomicity -- a save writes a unique ``<dir>/tmp.<step>.*`` directory and
    swaps it into place with renames only, so at every instant a complete
    copy of the step exists on disk; a manager sweeps crash debris at start
    (:func:`sweep_tmp_dirs`) and recovers a finished save that died between
    the two renames;
  * verification -- the manifest carries a crc32 per leaf, and
    :func:`restore_pytree` refuses a torn or bit-flipped payload with
    :class:`CheckpointCorrupt`;
  * walk-back -- retention keeps the newest K generations, and
    :func:`restore_latest_intact` walks back past corrupt ones;
  * async + retry -- :class:`CheckpointManager` writes on a daemon thread
    and retries a failed write with bounded backoff.

Format: one ``arrays.npz`` a generation, keyed by the flattened tree paths
of the reference (``group_0/lanes/.stat/lagged``, ``group_0/counts``: dict
keys, ``.field`` for a dataclass field, indices for sequences), and a JSON
manifest with the step, the sorted keys, the per-key crc32 of the raw leaf
bytes, ``dtypes`` (a bfloat16 leaf, which numpy has no type for, is stored
as its uint16 bits and named there, and restores bit for bit) and the
caller's ``meta``.  A generation written by either package
restores in the other.  Sessions record ``meta["tenant_axes"]``, from which
:func:`restore_tenant_pytree` slices one tenant out of a generation.

Trees are nests of dicts, dataclasses (`PartialState`), tuples and lists
whose leaves are tensors or numpy arrays (None is an empty subtree).  A
save converts every leaf to numpy in the caller's thread: device tensors
are copied to the host there, so the writer thread never touches the
device.  A restore puts each leaf where the template's leaf lies: a tensor
leaf on its tensor's device and dtype, a numpy leaf (a session's int64
cursor) on the host.

On a mesh (`repro_torch.parallel`): a DTensor leaf is saved whole (every
rank calls the save and gathers it; only rank 0 of the mesh writes, the
others wait for it at a barrier), and :func:`restore_pytree`'s
``shardings`` places leaves on the current mesh -- ``(mesh, [Shard(0)])``
gives each rank its rows, ``(mesh, [Replicate()])`` the whole array -- so a
generation written at one world size restores at another (elastic
restore).

Chaos hooks (`repro_torch.runtime.chaos`): ``checkpoint.write`` fires at the
top of every :func:`save_pytree`; ``checkpoint.payload`` is checked after
the payload lands (a ``corrupt`` rule tears the bytes on disk).
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointCorrupt", "CheckpointManager", "path_key", "save_pytree",
           "sweep_tmp_dirs", "latest_step", "restore_pytree", "list_steps",
           "restore_latest_intact", "load_manifest", "restore_tenant_pytree",
           "restore_tenant_latest_intact"]

class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed content verification (torn write, bit rot)."""


def _chaos():
    # function-scope import: runtime.fault imports this module
    from ..runtime import chaos

    return chaos


def path_key(path) -> str:
    """The flat key of one tree path: the .npz entry name and the key of
    every manifest table (checksums, ``meta["tenant_axes"]``)."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _items(tree: Any, path: tuple = ()) -> list:
    """(path, leaf) of every leaf, in the reference's flatten order: dict
    keys sorted, dataclass fields in declaration order."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _items(tree[k], path + (k,))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [e for f in dataclasses.fields(tree)
                for e in _items(getattr(tree, f.name), path + ("." + f.name,))]
    if isinstance(tree, (tuple, list)):
        return [e for i, x in enumerate(tree) for e in _items(x, path + (i,))]
    return [] if tree is None else [(path, tree)]


def _map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,)) for k in tree}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_with_path(fn, getattr(tree, f.name), path + ("." + f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        items = [_map_with_path(fn, x, path + (i,)) for i, x in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return None if tree is None else fn(path, tree)


def _to_host(leaf):
    """The leaf on the host: a numpy array, or for a bfloat16 tensor (numpy
    has no such type) a CPU tensor, stored by :func:`_stored`."""
    if _mesh_of(leaf) is not None:
        leaf = leaf.full_tensor()  # a collective: every rank of the mesh calls it
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.asarray(leaf)


def _stored(host) -> Tuple[np.ndarray, Optional[str]]:
    """(the array the payload holds, the dtype the manifest records for it
    or None): a bfloat16 leaf is stored as its uint16 bits, losslessly."""
    if isinstance(host, torch.Tensor):
        return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return host, None


def _from_stored(arr: np.ndarray, dtype: Optional[str]):
    """A payload array as the leaf it was: the bfloat16 bits of a leaf the
    manifest records as ``"bfloat16"`` as a CPU bfloat16 tensor."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


def _mesh_of(leaf):
    """The DeviceMesh of a DTensor leaf, else None."""
    return getattr(leaf, "device_mesh", None) if isinstance(leaf, torch.Tensor) else None


def _writes(tree: Any):
    """(this process writes, the group to wait on): a tree with DTensor
    leaves is written by rank 0 of their mesh only."""
    meshes = [m for m in (_mesh_of(leaf) for _, leaf in _items(tree)) if m is not None]
    if not meshes:
        return True, None
    mesh = meshes[0]
    if any(m is not mesh for m in meshes):
        raise ValueError("the DTensor leaves of one checkpoint must share one mesh")
    return mesh.get_local_rank() == 0, mesh.get_group()


def _flatten(tree: Any) -> Dict[str, Any]:
    return {path_key(p): _to_host(leaf) for p, leaf in _items(tree)}


def _structure(tree: Any) -> str:
    """A readable description of the tree's nesting (the manifest's
    ``treedef``: recorded, never read back)."""
    return "repro_torch:" + ",".join(path_key(p) for p, _ in _items(tree))


def _checksum(arr: np.ndarray) -> int:
    """crc32 of the leaf's raw bytes (C order), read through a byte view of
    the array rather than a copy of it."""
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(raw) & 0xFFFFFFFF


def save_pytree(tree: Any, directory: str, step: int, meta: Optional[dict] = None) -> str:
    """Synchronous atomic save; returns the generation's path.  ``meta``
    (JSON-serializable) is recorded verbatim in the manifest.  A tree with
    DTensor leaves is saved by every rank of their mesh together: each
    leaf is gathered whole, rank 0 writes, and every rank returns once the
    generation is in place."""
    writer, group = _writes(tree)
    if group is None:
        _chaos().fire("checkpoint.write")  # injected transient IO failure point
        return _write(_flatten(tree), tree, directory, step, meta)
    flat = _flatten(tree)  # the gathers: every rank takes part
    try:
        if not writer:
            return os.path.join(directory, f"step_{step:010d}")
        _chaos().fire("checkpoint.write")
        return _write(flat, tree, directory, step, meta)
    finally:
        torch.distributed.barrier(group=group)


def _write(flat: Dict[str, Any], tree: Any, directory: str, step: int,
           meta: Optional[dict]) -> str:
    chaos = _chaos()
    stored = {k: _stored(v) for k, v in flat.items()}
    flat = {k: arr for k, (arr, _) in stored.items()}
    dtypes = {k: dt for k, (_, dt) in stored.items() if dt is not None}
    os.makedirs(directory, exist_ok=True)
    # a unique tmp name: two writers of one step never collide, and a crash
    # mid-write leaves an identifiable orphan for sweep_tmp_dirs
    tmp = tempfile.mkdtemp(prefix=f"tmp.{step}.", dir=directory)
    final = os.path.join(directory, f"step_{step:010d}")
    payload = os.path.join(tmp, "arrays.npz")
    np.savez(payload, **flat)
    if chaos.should_corrupt("checkpoint.payload"):
        # tear the written payload in place: the checksums below come from
        # the intact arrays, so verification must refuse this generation
        with open(payload, "r+b") as f:
            f.seek(max(os.path.getsize(payload) // 2, 0))
            f.write(b"\x00CHAOS-TORN\x00")
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "treedef": _structure(tree), "keys": sorted(flat),
                   "checksums": {k: _checksum(v) for k, v in flat.items()},
                   "dtypes": dtypes, "meta": dict(meta or {})}, f)
    # swap, never delete-then-rename: the old generation of this step moves
    # aside under a unique trash name first
    trash = None
    if os.path.exists(final):
        trash = tempfile.mkdtemp(prefix=f"trash.{step}.", dir=directory)
        os.rmdir(trash)
        os.rename(final, trash)
    os.rename(tmp, final)
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)
    return final


def sweep_tmp_dirs(directory: str) -> list:
    """Clear the debris of crashed saves (``tmp.*`` / ``trash.*``).  A
    complete tmp dir whose ``step_*`` target is missing is a finished save
    that died between the renames: it is moved into place, not discarded.
    Returns the recovered generations' paths."""
    if not os.path.isdir(directory):
        return []
    recovered = []
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("tmp.") or name.startswith("trash.")):
            continue
        path = os.path.join(directory, name)
        if not os.path.isdir(path):
            continue
        step = None
        if name.startswith("tmp."):
            try:
                with open(os.path.join(path, "manifest.json")) as f:
                    step = int(json.load(f)["step"])
            except (OSError, ValueError, KeyError, json.JSONDecodeError):
                step = None  # an incomplete write: plain debris
        if step is not None:
            final = os.path.join(directory, f"step_{step:010d}")
            if not os.path.exists(final):
                os.rename(path, final)
                recovered.append(final)
                continue
        shutil.rmtree(path, ignore_errors=True)
    return recovered


def list_steps(directory: str) -> list:
    """Every generation on disk under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n.split("_")[1]) for n in os.listdir(directory) if n.startswith("step_"))


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _load_checksums(step_dir: str) -> Optional[Dict[str, int]]:
    """The manifest's per-key checksums, or None for a generation written
    before checksums existed (it restores unverified)."""
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    sums = manifest.get("checksums")
    if not isinstance(sums, dict):
        return None
    return {k: int(v) for k, v in sums.items()}


def _load_dtypes(step_dir: str) -> Dict[str, str]:
    """The manifest's ``dtypes``: the leaves stored in another type than
    their own (bfloat16 as uint16 bits); empty for a generation without."""
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            dtypes = json.load(f).get("dtypes")
    except (OSError, ValueError):
        return {}
    return dtypes if isinstance(dtypes, dict) else {}


def load_manifest(directory: str, step: int) -> dict:
    """One generation's manifest; :class:`CheckpointCorrupt` when it is
    missing or unparseable."""
    path = os.path.join(directory, f"step_{step:010d}", "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"manifest of checkpoint step {step} under {directory} is "
                                f"unreadable: {e!r}") from e


def _resolve_step(directory: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return step


def _open_payload(directory: str, step: int):
    try:
        return np.load(os.path.join(directory, f"step_{step:010d}", "arrays.npz"))
    except Exception as e:  # a truncated zip, a missing file, ...
        raise CheckpointCorrupt(f"checkpoint step {step} under {directory} is unreadable: "
                                f"{e!r}") from e


def _verified_leaf(data, key: str, checksums, step: int, directory: str,
                   shape: tuple) -> np.ndarray:
    """One leaf of an open payload, its crc32 checked against the manifest
    and its shape against the template's."""
    try:
        arr = data[key]
    except KeyError:
        raise CheckpointCorrupt(f"checkpoint step {step} under {directory} is missing leaf "
                                f"{key!r}") from None
    except Exception as e:  # zipfile.BadZipFile on a torn entry, ...
        raise CheckpointCorrupt(f"checkpoint leaf {key!r} of step {step} under {directory} "
                                f"is unreadable: {e!r}") from e
    if checksums is not None:
        want, got = checksums.get(key), _checksum(arr)
        if want is not None and got != want:
            raise CheckpointCorrupt(f"checkpoint leaf {key!r} of step {step} under "
                                    f"{directory} fails verification (crc32 {got} != "
                                    f"manifest {want}): torn write or bit rot")
    if tuple(arr.shape) != shape:
        raise ValueError(f"checkpoint leaf {key!r} has shape {tuple(arr.shape)} but the "
                         f"restore template expects {shape} (step {step} under {directory})")
    return arr


def _tensor(arr) -> torch.Tensor:
    """A host tensor of ``arr``, of its shape (``np.ascontiguousarray``
    makes a 0-d array 1-d)."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(np.shape(arr)))


def _like(arr, leaf) -> Any:
    """``arr`` (a numpy array, or a bfloat16 tensor from
    :func:`_from_stored`) where the template ``leaf`` lies: a tensor on its
    device and dtype, else a host numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        return _tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(arr, torch.Tensor):
        arr = arr.float().numpy()
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def _placed(arr: np.ndarray, leaf, sharding) -> Any:
    """``arr`` (the whole leaf) on a mesh: ``sharding`` is (mesh,
    placements), one placement, ``Shard(0)`` (this rank's rows) or
    ``Replicate()`` (the whole array), as a DTensor of the template leaf's
    dtype."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..parallel.sharding import mesh_device

    mesh, placements = sharding
    (placement,) = placements
    if isinstance(placement, Shard) and placement.dim == 0 and mesh.ndim == 1:
        world, rank = mesh.size(), mesh.get_local_rank()
        if arr.shape[0] % world:
            raise ValueError(f"a leaf of {arr.shape[0]} rows cannot be sharded over {world} "
                             f"ranks")
        per = arr.shape[0] // world
        arr = arr[rank * per: (rank + 1) * per]
    elif not isinstance(placement, Replicate):
        raise ValueError(f"restore places leaves by Shard(0) on a 1-D mesh or Replicate(), "
                         f"got {placement}")
    local = _tensor(arr).to(device=mesh_device(mesh), dtype=leaf.dtype)
    return DTensor.from_local(local, mesh, [placement], run_check=False)


def _sharding_at(shardings: Any, path: tuple):
    """The entry of ``shardings`` (a tree shaped like the template, or None)
    at a template leaf's path: None or a (mesh, placements) pair."""
    for p in path:
        if shardings is None:
            return None
        shardings = (getattr(shardings, p[1:]) if isinstance(p, str) and p.startswith(".")
                     else shardings[p])
    return shardings


def restore_pytree(template: Any, directory: str, step: Optional[int] = None,
                   shardings: Any = None, verify: bool = True) -> Any:
    """Restore a generation (the newest by default) into the structure of
    ``template``, each leaf checked against the manifest's crc32 (unless
    ``verify`` is off) and placed where the template's leaf lies, or where
    ``shardings`` says: a tree shaped like the template whose entries are
    None (the template's placement) or a ``(DeviceMesh, placements)`` pair
    (a DTensor of this rank's rows for ``[Shard(0)]``, of the whole array
    for ``[Replicate()]``).  A generation written at any world size
    restores at any other."""
    step = _resolve_step(directory, step)
    step_dir = os.path.join(directory, f"step_{step:010d}")
    checksums = _load_checksums(step_dir) if verify else None
    dtypes = _load_dtypes(step_dir)
    data = _open_payload(directory, step)

    def leaf_of(path, leaf):
        key = path_key(path)
        arr = _from_stored(_verified_leaf(data, key, checksums, step, directory,
                                          tuple(np.shape(leaf))), dtypes.get(key))
        sharding = _sharding_at(shardings, path)
        return _like(arr, leaf) if sharding is None else _placed(arr, leaf, sharding)

    return _map_with_path(leaf_of, template)


def restore_latest_intact(template: Any, directory: str,
                          shardings: Any = None) -> Tuple[Any, int, list]:
    """Restore the newest generation that verifies, walking back past torn
    or corrupt ones: ``(state, step, skipped)``, ``skipped`` newest first.
    ``FileNotFoundError`` without generations, :class:`CheckpointCorrupt`
    when every one is corrupt."""
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    skipped: list = []
    for step in reversed(steps):
        try:
            return restore_pytree(template, directory, step, shardings), step, skipped
        except CheckpointCorrupt:
            skipped.append(step)
    raise CheckpointCorrupt(f"every retained checkpoint generation under {directory} is "
                            f"corrupt (steps {skipped})")


def _restore_tenant_host(template: Any, directory: str, tenant: int, step: int,
                         verify: bool) -> Any:
    """ONE tenant's slice of a generation as numpy leaves (the template's
    structure, each leaf verified in full before slicing)."""
    manifest = load_manifest(directory, step)
    axes = manifest.get("meta", {}).get("tenant_axes")
    if not isinstance(axes, dict):
        raise CheckpointCorrupt(f"checkpoint step {step} under {directory} carries no "
                                f"tenant_axes metadata: written before per-tenant extraction "
                                f"existed, or by a saver that is not a session gateway")
    step_dir = os.path.join(directory, f"step_{step:010d}")
    checksums = _load_checksums(step_dir) if verify else None
    dtypes = _load_dtypes(step_dir)
    data = _open_payload(directory, step)

    def leaf_of(path, leaf):
        key = path_key(path)
        arr = _verified_leaf(data, key, checksums, step, directory, tuple(np.shape(leaf)))
        ax = axes.get(key)
        if ax is None:
            raise CheckpointCorrupt(f"checkpoint step {step} under {directory} has no tenant "
                                    f"axis recorded for leaf {key!r}")
        ax = int(ax)
        if not 0 <= tenant < arr.shape[ax]:
            raise ValueError(f"tenant {tenant} out of range [0, {arr.shape[ax]}) on leaf "
                             f"{key!r} (axis {ax})")
        return _from_stored(np.take(arr, tenant, axis=ax), dtypes.get(key))

    return _map_with_path(leaf_of, template)


def restore_tenant_pytree(template: Any, directory: str, tenant: int,
                          step: Optional[int] = None, verify: bool = True) -> Any:
    """ONE tenant's slice of a full-session generation (the newest by
    default): ``template`` is the FULL session template, and each leaf's
    tenant axis (``meta["tenant_axes"]``) is sliced to ``tenant`` -- the
    payload of `FrameSession.import_tenant`."""
    step = _resolve_step(directory, step)
    host = _restore_tenant_host(template, directory, int(tenant), step, verify)
    return _map_with_path(lambda path, leaf: _like(_pick(host, path), leaf), template)


def _pick(tree: Any, path: tuple) -> Any:
    for p in path:
        tree = getattr(tree, p[1:]) if isinstance(p, str) and p.startswith(".") else tree[p]
    return tree


def restore_tenant_latest_intact(template: Any, directory: str, tenant: int,
                                 verify: bool = True) -> Tuple[Any, int, list]:
    """The newest generation from which ``tenant``'s slice extracts,
    verifies AND is all-finite (a poisoned lane that reached a snapshot
    verifies, but restoring it would re-plant the damage): ``(tenant_state,
    step, skipped)``."""
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    tenant = int(tenant)
    skipped: list = []
    for step in reversed(steps):
        try:
            host = _restore_tenant_host(template, directory, tenant, step, verify)
            for _, arr in _items(host):
                if isinstance(arr, torch.Tensor):
                    arr = arr.float().numpy()
                if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
                    raise CheckpointCorrupt(f"step {step}: tenant {tenant}'s slice holds "
                                            f"non-finite values, poisoned before the snapshot")
            state = _map_with_path(lambda path, leaf: _like(_pick(host, path), leaf), template)
            return state, step, skipped
        except CheckpointCorrupt:
            skipped.append(step)
    raise CheckpointCorrupt(f"no retained checkpoint generation under {directory} yields an "
                            f"intact slice for tenant {tenant} (skipped {skipped})")


class CheckpointManager:
    """Async checkpoints with retention, write retry and a flush.

    ``save`` converts the tree to host arrays in the caller's thread and
    queues it; a daemon thread writes it.  A failed write is retried
    ``retries`` times after ``backoff * 2**attempt`` seconds before the
    error is recorded; ``flush`` blocks until the queue drains and raises
    the first recorded error.  Pass host copies (`FrameSession.
    export_state`): CPU tensors and numpy leaves are written as they are,
    not copied again, so they must not change after ``save``.
    """

    def __init__(self, directory: str, keep: int = 3, retries: int = 2, backoff: float = 0.05):
        self.directory = directory
        self.keep = keep
        self.retries = retries
        self.backoff = backoff
        # a previous process that crashed mid-save left debris behind
        self.recovered = sweep_tmp_dirs(directory)
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.saved_steps: list = []
        self.retried_saves: int = 0
        self._errors: list = []

    def _save_with_retry(self, tree, step, meta=None) -> None:
        for attempt in range(self.retries + 1):
            try:
                if meta is None:
                    save_pytree(tree, self.directory, step)
                else:
                    save_pytree(tree, self.directory, step, meta=meta)
                return
            except Exception:
                # the half-written tmp dir stays; sweep_tmp_dirs clears it
                if attempt == self.retries:
                    raise
                self.retried_saves += 1
                time.sleep(self.backoff * (2 ** attempt))

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            tree, step, meta = item
            try:
                self._save_with_retry(tree, step, meta)
                self.saved_steps.append(step)
                self._gc()
            except Exception as e:  # surfaced through flush()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        for s in list_steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    def save(self, tree: Any, step: int, meta: Optional[dict] = None) -> None:
        """Queue a save of ``tree``.  DTensor leaves are gathered here (every
        rank of their mesh calls ``save``) and only rank 0 of the mesh
        queues the write."""
        writer, _ = _writes(tree)
        host_tree = _map_with_path(lambda _, leaf: _to_host(leaf), tree)  # off the device now
        if writer:
            self._q.put((host_tree, step, meta))

    def flush(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        # the sentinel must reach the worker even when flush() raises
        try:
            self.flush()
        finally:
            self._q.put(None)
            self._q.join()
            self._worker.join(timeout=5.0)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)
