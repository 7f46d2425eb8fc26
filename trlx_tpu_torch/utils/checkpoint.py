"""Crash-atomic, self-managing component checkpoints (port of
trlx_tpu.utils.checkpoint).

- :func:`save_components` writes into a ``<dir>.tmp-<pid>`` staging
  directory and commits with ``os.replace``: a process killed mid-save
  leaves a dead staging directory and the previous checkpoint intact,
  never a half-written directory under the final name. Every rename is
  followed by an fsync of the parent directory, so the commit survives a
  power loss too.
- ``meta.json`` holds the plain-Python components and the
  ``__manifest__`` of per-file SHA-256 digests; it is written last,
  through its own temp file and ``os.replace``, and is the commit
  marker.
- Step checkpoints live under a run directory as ``step_<N>/`` with an
  atomically written ``LATEST``; :func:`find_latest_checkpoint` skips
  staging leftovers and directories without ``meta.json``;
  :func:`gc_checkpoints` keeps the newest ``keep``.
- Every restore verifies the bytes against the manifest first
  (:func:`verify_checkpoint` raises :class:`CheckpointCorrupt`); a
  corrupt directory is renamed ``<dir>.corrupt-<pid>``
  (:func:`quarantine_checkpoint`). A restore from a run directory then
  falls back to the previous good step; a checkpoint named directly
  fails fast. A missing path or component gives ONE error naming what
  was expected and what is on disk.

Storage: each component whose leaves are all tensors (nested dicts and
lists of them) is one ``<name>.pt`` file written by ``torch.save`` with
every tensor moved to the CPU first, and read back with
``torch.load(..., weights_only=True)``; zero-size tensors round-trip.
:func:`restore_components` puts each tensor back on the template
leaf's device in its dtype.

On a device mesh (trlx_tpu_torch.parallel) the file format stays this
plain one, whole tensors: every process gathers each DTensor leaf
(``full_tensor``) and the main process writes, then every process waits
for the commit; a restore is read by the main process and distributed
to the template's placements (DTensor leaves) or broadcast (plain
leaves and the plain-Python components). So a checkpoint written on a
mesh restores in one plain process, and the reverse.
"""

import hashlib
import itertools
import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.parallel.runtime import is_main_process, process_count
from trlx_tpu_torch.parallel.sharding import is_dtensor, zip_map

#: commit marker: always written, and written LAST — a directory without
#: it is a torn write, not a checkpoint
META_NAME = "meta.json"
LATEST_NAME = "LATEST"
#: reserved meta.json key carrying the per-file integrity manifest
MANIFEST_KEY = "__manifest__"
#: suffix of a tensor component's file
TENSOR_SUFFIX = ".pt"
_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointCorrupt(RuntimeError):
    """Checkpoint bytes failed verification against the manifest in its
    commit marker (bit-rot, truncation, a torn meta.json)."""


def _tensor_leaves(obj: Any):
    """The leaves of nested dicts / lists / tuples."""
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _tensor_leaves(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _tensor_leaves(v)]
    return [obj]


def _is_tensor_tree(obj: Any) -> bool:
    leaves = _tensor_leaves(obj)
    return bool(leaves) and all(torch.is_tensor(x) for x in leaves)


def _to_cpu(obj: Any) -> Any:
    """A copy of a tensor tree on the CPU (each tensor its own compact
    storage, so a view never drags its base into the file); a DTensor
    leaf is gathered whole first (a collective every process runs)."""
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    if is_dtensor(obj):
        obj = obj.full_tensor()
    return obj.detach().to("cpu", copy=True)


def _distributed() -> bool:
    return process_count() > 1


def _barrier() -> None:
    """Every process waits for the main process's commit (a no-op in one
    process), so all of them see the same run directory next."""
    if _distributed():
        import torch.distributed as dist

        dist.barrier()


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-committed rename survives power loss
    (the renamed entry lives in the directory's blocks). Best-effort
    where directories cannot be opened or fsynced."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        return
    finally:
        os.close(fd)


def _atomic_write_text(text: str, path: str) -> None:
    """Write-temp-then-rename, then fsync the parent: readers see the old
    content or the new, never a torn write."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def is_valid_checkpoint(directory: str) -> bool:
    """A committed checkpoint: exists, is not a staging / aside /
    quarantine leftover, and carries the commit marker."""
    base = os.path.basename(os.path.normpath(directory))
    if ".tmp-" in base or ".old-" in base or ".corrupt-" in base:
        return False
    return os.path.isdir(directory) and os.path.exists(
        os.path.join(directory, META_NAME))


def _file_sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def build_manifest(directory: str) -> Dict[str, Dict[str, Any]]:
    """``{relpath: {"sha256": hex, "bytes": size}}`` of every file under
    ``directory`` except meta.json, with '/' separators."""
    directory = os.path.abspath(directory)
    manifest: Dict[str, Dict[str, Any]] = {}
    for root, _, files in os.walk(directory):
        for fname in sorted(files):
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, directory).replace(os.sep, "/")
            if rel == META_NAME:
                continue
            manifest[rel] = {"sha256": _file_sha256(path),
                             "bytes": os.path.getsize(path)}
    return manifest


def verify_checkpoint(directory: str, component: Optional[str] = None) -> bool:
    """Verify ``directory``'s bytes against the manifest in its commit
    marker: True when verified, False when the checkpoint carries no
    manifest (``checkpoint/verify_skipped``). Raises
    :class:`CheckpointCorrupt` naming the first damaged file, and for a
    torn or unreadable meta.json, and for an injected
    ``checkpoint_verify`` chaos fault (the drill seam, fired first).
    ``component`` limits the check to that component's file."""
    directory = os.path.abspath(directory)

    def corrupt(detail: str) -> CheckpointCorrupt:
        telemetry.inc("checkpoint/verify_failures")
        return CheckpointCorrupt(
            f"checkpoint '{directory}' failed integrity verification: "
            f"{detail}. The bytes on disk are not the bytes that were "
            f"saved — do not install them; quarantine and fall back to the "
            f"previous step.")

    from trlx_tpu_torch.supervisor import chaos

    try:
        # the drill seam: an injected exc IS a verification failure,
        # driving quarantine exactly as real bit-rot would
        chaos.maybe_inject("checkpoint_verify")
    except chaos.ChaosError as e:
        raise corrupt(f"chaos-injected ({e})") from e
    try:
        with open(os.path.join(directory, META_NAME)) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise corrupt(f"torn/unreadable '{META_NAME}' ({type(e).__name__}: "
                      f"{e}) — the commit marker itself is damaged") from e
    manifest = meta.get(MANIFEST_KEY) if isinstance(meta, dict) else None
    if manifest is None:
        telemetry.inc("checkpoint/verify_skipped")
        return False
    files = dict(manifest.get("files") or {})
    if component is not None:
        files = {rel: e for rel, e in files.items()
                 if rel == component + TENSOR_SUFFIX}
    for rel in sorted(files):
        entry = files[rel]
        path = os.path.join(directory, *rel.split("/"))
        try:
            size = os.path.getsize(path)
        except OSError:
            raise corrupt(f"'{rel}' is missing from disk") from None
        if int(entry.get("bytes", size)) != size:
            raise corrupt(f"'{rel}' is truncated: manifest says "
                          f"{entry['bytes']} bytes, disk has {size}")
        digest = _file_sha256(path)
        if digest != entry.get("sha256"):
            raise corrupt(f"'{rel}' content hash mismatch (sha256 {digest} "
                          f"!= manifest {entry.get('sha256')}) — bit-rot or "
                          f"an out-of-band overwrite")
    telemetry.inc("checkpoint/verified")
    return True


#: collision counter for quarantine names within one process
_quarantine_seq = itertools.count(1)


def quarantine_checkpoint(directory: str, reason: str = "") -> Optional[str]:
    """Rename a corrupt checkpoint aside as ``<dir>.corrupt-<pid>`` so
    :func:`find_latest_checkpoint` stops resolving it (quarantined
    directories are never collected). Returns the new path, or None when
    the directory is gone."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    aside = f"{directory}.corrupt-{os.getpid()}"
    while os.path.exists(aside):
        aside = f"{directory}.corrupt-{os.getpid()}-{next(_quarantine_seq)}"
    try:
        os.replace(directory, aside)
    except OSError:
        return None
    _fsync_dir(os.path.dirname(aside) or ".")
    telemetry.inc("checkpoint/quarantined")
    print(f"[trlx_tpu_torch] QUARANTINED corrupt checkpoint '{directory}' "
          f"-> '{aside}'" + (f" ({reason})" if reason else ""), flush=True)
    return aside


def verify_or_quarantine(directory: str,
                         component: Optional[str] = None) -> bool:
    """:func:`verify_checkpoint`, quarantining the directory on failure
    before re-raising."""
    try:
        return verify_checkpoint(directory, component=component)
    except CheckpointCorrupt as e:
        aside = quarantine_checkpoint(directory, reason=str(e))
        if aside is not None:
            raise CheckpointCorrupt(f"{e} [quarantined to '{aside}']") from e
        raise


def save_components(components: Dict[str, Any], directory: str) -> None:
    """Write every component under ``directory``, crash-atomically: tensor
    trees as ``<name>.pt``, the rest into meta.json with the manifest,
    all in a staging directory that is renamed into place. An existing
    checkpoint is renamed aside first and deleted only after the new one
    is committed. With several processes every one of them calls this:
    all gather, the main process writes, all wait for the commit."""
    _save_components(components, directory)
    _barrier()


def _save_components(components: Dict[str, Any], directory: str) -> None:
    tensors = {name: _to_cpu(obj) for name, obj in components.items()
               if _is_tensor_tree(obj)}
    if not is_main_process():
        return
    with telemetry.span("checkpoint_save"):
        directory = os.path.abspath(directory)
        parent = os.path.dirname(directory)
        os.makedirs(parent, exist_ok=True)
        staging = f"{directory}.tmp-{os.getpid()}"
        if os.path.isdir(staging):
            shutil.rmtree(staging)  # leftover of an earlier crashed save
        os.makedirs(staging)
        meta = {}
        for name, obj in components.items():
            if name in tensors:
                path = os.path.join(staging, name + TENSOR_SUFFIX)
                with open(path, "wb") as f:
                    torch.save(tensors[name], f)
                    f.flush()
                    os.fsync(f.fileno())
            else:
                meta[name] = obj
        meta[MANIFEST_KEY] = {"algo": "sha256",
                              "files": build_manifest(staging)}
        _atomic_write_text(json.dumps(meta), os.path.join(staging, META_NAME))
        if os.path.isdir(directory):
            aside = f"{directory}.old-{os.getpid()}"
            if os.path.isdir(aside):
                shutil.rmtree(aside)
            os.replace(directory, aside)
            _fsync_dir(parent)
            os.replace(staging, directory)
            shutil.rmtree(aside)
        else:
            os.replace(staging, directory)
        _fsync_dir(parent)
        telemetry.inc("checkpoint/saves")


def step_dir(run_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(run_dir), f"step_{int(step)}")


def find_latest_checkpoint(run_dir: str) -> Optional[str]:
    """Newest VALID ``step_<N>`` checkpoint under ``run_dir``, or None:
    ``LATEST`` when it names a valid directory, else a scan that skips
    half-written ones."""
    run_dir = os.path.abspath(run_dir)
    if not os.path.isdir(run_dir):
        return None
    latest_path = os.path.join(run_dir, LATEST_NAME)
    if os.path.exists(latest_path):
        with open(latest_path) as f:
            named = os.path.join(run_dir, f.read().strip())
        if is_valid_checkpoint(named):
            return named
    best, best_step = None, -1
    for entry in os.listdir(run_dir):
        m = _STEP_RE.match(entry)
        if not m:
            continue
        path = os.path.join(run_dir, entry)
        if int(m.group(1)) > best_step and is_valid_checkpoint(path):
            best, best_step = path, int(m.group(1))
    return best


def gc_checkpoints(run_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` committed step directories
    (``keep <= 0`` keeps everything) and every staging / aside leftover
    or torn step directory."""
    run_dir = os.path.abspath(run_dir)
    if not os.path.isdir(run_dir):
        return
    steps = []
    for entry in os.listdir(run_dir):
        path = os.path.join(run_dir, entry)
        if ".tmp-" in entry or ".old-" in entry:  # a dead staging dir or
            if os.path.isdir(path):               # a torn LATEST temp file
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)
            telemetry.inc("fault/checkpoint_debris_cleared")
            continue
        m = _STEP_RE.match(entry)
        if not m:
            continue
        if not is_valid_checkpoint(path):
            shutil.rmtree(path, ignore_errors=True)
            telemetry.inc("fault/checkpoint_debris_cleared")
            continue
        steps.append((int(m.group(1)), path))
    if keep and keep > 0:
        for _, path in sorted(steps)[:-keep]:
            shutil.rmtree(path, ignore_errors=True)


def save_step_checkpoint(components: Dict[str, Any], run_dir: str, step: int,
                         keep: int = 0) -> str:
    """``run_dir/step_<step>``: atomic save, atomic ``LATEST`` update,
    then retention. Returns the checkpoint path."""
    path = step_dir(run_dir, step)
    _save_components(components, path)
    if is_main_process():
        _atomic_write_text(os.path.basename(path),
                           os.path.join(os.path.dirname(path), LATEST_NAME))
        gc_checkpoints(run_dir, keep)
    _barrier()
    return path


def resolve_verified_dir(directory: str, expected,
                         component: Optional[str] = None) -> str:
    """Resolve ``directory`` (a checkpoint or a run directory), verify the
    candidate and, on corruption, quarantine it and — for a run
    directory — resolve again, walking back to the previous good step.
    A corrupt checkpoint named directly re-raises."""
    previous = None
    while True:
        pointed_directly = is_valid_checkpoint(directory)
        resolved = directory if pointed_directly \
            else find_latest_checkpoint(directory)
        if resolved is None:
            if os.path.isdir(directory):
                contents = sorted(os.listdir(directory)) or ["<empty>"]
                detail = ("exists but holds no committed checkpoint: "
                          f"{contents}")
            else:
                detail = "does not exist"
            raise FileNotFoundError(
                f"no checkpoint at '{directory}' ({detail}). Expected either "
                f"a checkpoint directory with components {expected} + "
                f"'{META_NAME}', or a run directory containing committed "
                f"'step_<N>' checkpoints. A save killed mid-write leaves only "
                f"a '*.tmp-*' staging dir and a corrupt one is quarantined as "
                f"'*.corrupt-*' — neither is restorable; point resume_from at "
                f"the run directory (or 'auto') to fall back to the newest "
                f"committed step.")
        try:
            verify_or_quarantine(resolved, component=component)
            return resolved
        except CheckpointCorrupt:
            if pointed_directly or resolved == previous:
                raise
            previous = resolved
            print(f"[trlx_tpu_torch] falling back past corrupt checkpoint "
                  f"'{resolved}' to the previous good step under "
                  f"'{directory}'", flush=True)


def _onto(template: Any, loaded: Any, where: str) -> Any:
    """``loaded`` in ``template``'s structure, each tensor on the template
    leaf's device in its dtype; a structure or shape mismatch raises."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            raise ValueError(
                f"checkpoint tree at '{where}' has keys "
                f"{sorted(loaded) if isinstance(loaded, dict) else loaded!r}"
                f", the trainer expects {sorted(template)}")
        return {k: _onto(v, loaded[k], f"{where}.{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) \
                or len(loaded) != len(template):
            raise ValueError(f"checkpoint tree at '{where}' does not match "
                             f"the trainer's {len(template)} entries")
        return type(template)(_onto(t, x, f"{where}.{i}")
                              for i, (t, x) in enumerate(zip(template,
                                                             loaded)))
    if tuple(loaded.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint tensor '{where}' has shape "
                         f"{tuple(loaded.shape)}, the trainer expects "
                         f"{tuple(template.shape)}")
    return loaded.to(device=template.device, dtype=template.dtype)


def restore_components(template: Dict[str, Any],
                       directory: str) -> Dict[str, Any]:
    """Restore into the structure of ``template`` (a trainer's
    ``get_components()``). ``directory`` may be a checkpoint or a run
    directory (the newest valid step is used, falling back past corrupt
    ones). A missing component raises one error naming what was expected
    and what is on disk."""
    with telemetry.span("checkpoint_restore"):
        if not _distributed():
            return _placed(template, _restore_components(template,
                                                         directory))
        return _restore_distributed(template, directory)


def _placed(template: Any, restored: Any) -> Any:
    """``restored`` (whole tensors) with every leaf whose template leaf is
    a DTensor distributed to that leaf's placements (one process: each
    its own shard of the same whole tensor)."""
    if isinstance(template, dict):
        return {k: _placed(v, restored[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_placed(t, x)
                              for t, x in zip(template, restored))
    if is_dtensor(template):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(restored, template.device_mesh,
                                 template.placements, src_data_rank=None)
    return restored


def _restore_distributed(template, directory):
    """The main process restores (verification, fallback, quarantine and
    errors as in one process); the others receive: a DTensor leaf
    through ``distribute_tensor`` from process 0 onto the template's
    placements, a plain tensor leaf and the plain-Python components
    through broadcasts. An error on the main process is raised on every
    process."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    loaded, error = None, None
    if is_main_process():
        try:
            loaded = _restore_components(template, directory)
        except Exception as e:  # re-raised below, on every process
            error = e
    msg = [None if error is None else (type(error).__name__, str(error))]
    dist.broadcast_object_list(msg, src=0)
    if error is not None:
        raise error
    if msg[0] is not None:
        kinds = {"FileNotFoundError": FileNotFoundError,
                 "ValueError": ValueError,
                 "CheckpointCorrupt": CheckpointCorrupt}
        raise kinds.get(msg[0][0], RuntimeError)(
            f"on the main process: {msg[0][1]}")

    main = loaded is not None

    def receive(t, x):
        if not main:
            x = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        if is_dtensor(t):
            return distribute_tensor(x, t.device_mesh, t.placements,
                                     src_data_rank=0)
        dist.broadcast(x, src=0)
        return x

    out = {}
    for name, obj in template.items():
        if _is_tensor_tree(obj):
            out[name] = zip_map(receive, obj, loaded[name] if main else obj)
        else:
            box = [loaded[name] if main else None]
            dist.broadcast_object_list(box, src=0)
            out[name] = box[0]
    return out


def _restore_components(template, directory):
    directory = resolve_verified_dir(os.path.abspath(directory),
                                     sorted(template))
    with open(os.path.join(directory, META_NAME)) as f:
        meta = json.load(f)
    missing = [name for name in template
               if not os.path.isfile(os.path.join(
                   directory, name + TENSOR_SUFFIX)) and name not in meta]
    if missing:
        raise FileNotFoundError(
            f"checkpoint '{directory}' is missing components {missing}: "
            f"expected {sorted(template)}, found on disk "
            f"{sorted(os.listdir(directory))} with meta keys {sorted(meta)}. "
            f"The checkpoint was probably written by a different trainer or "
            f"method — components must match the restoring trainer's "
            f"get_components().")
    out = {}
    for name, obj in template.items():
        path = os.path.join(directory, name + TENSOR_SUFFIX)
        if os.path.isfile(path):
            loaded = torch.load(path, map_location="cpu", weights_only=True)
            out[name] = _onto(obj, loaded, name) if _is_tensor_tree(obj) \
                else loaded
        else:
            out[name] = meta[name]
    telemetry.inc("checkpoint/restores")
    return out


def restore_tensor_component(name: str, directory: str,
                             mmap: bool = False) -> Any:
    """ONE tensor component of a checkpoint or run directory (verified
    first, falling back like :func:`restore_components`), on the CPU as
    stored; returns ``(tree, meta, resolved directory)``. ``mmap`` maps
    the file instead of reading it, so only the bytes a caller then
    touches (:func:`slice_tree`) are read."""
    resolved = resolve_verified_dir(os.path.abspath(directory), [name],
                                    component=name)
    path = os.path.join(resolved, name + TENSOR_SUFFIX)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"checkpoint '{resolved}' has no tensor component '{name}' "
            f"(found on disk: {sorted(os.listdir(resolved))})")
    with open(os.path.join(resolved, META_NAME)) as f:
        meta = json.load(f)
    tree = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=mmap)
    telemetry.inc("checkpoint/restores")
    return tree, meta, resolved


def slice_tree(tree: Any, slicer) -> Any:
    """The slice-wise partial restore: every tensor leaf of ``tree`` (a
    component as :func:`restore_tensor_component` loads it, memory-mapped)
    cut by ``slicer(path, tensor)`` — the key path as a tuple of names and
    the whole tensor, returning a view of it — and copied out, so only the
    slice's bytes are read from the file. The format is the plain one of
    every save: a checkpoint written by one process restores sliced on a
    serve mesh."""
    def walk(x, path):
        if isinstance(x, dict):
            return {k: walk(v, path + (str(k),)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, path + (str(i),)) for i, v in enumerate(x))
        if torch.is_tensor(x):
            return slicer(path, x).clone()
        return x

    return walk(tree, ())
