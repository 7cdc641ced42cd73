"""Durable checkpoint/resume for device-resident rollback state: the port's
copy of `ggrs_tpu/utils/checkpoint.py`, in the same file format, so a file
written by either stack restores in the other.

The reference's snapshot system is memory-only — nothing survives process
death (SURVEY.md §5). Here a tree of host arrays (the fused session's
carry, the backend's ring + live state, in the reference's layout:
`ggrs_tpu_torch.convert`) can be written to one .npz file and restored
bit-exactly, so a determinism soak or a long-running session can stop and
resume. Format: flattened key-path -> array pairs plus a JSON meta blob;
integers/arrays only, so restores are exact by construction. The caller
moves its tensors to the host; this module is numpy only.

Every checkpoint is stamped with a FORMAT VERSION and a payload MANIFEST
(array path -> shape/dtype): a restore validates both up front and raises
a typed `CheckpointIncompatible` naming exactly what differs — a truncated
file, a corrupted member or a checkpoint written by a newer build fails at
the door with an operator-facing message, never as a shape error deep
inside the restore. Version-1 files (pre-stamp) still load: the stamp is
additive, absence means "legacy, best effort".
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np

from ..errors import CheckpointIncompatible

# version 2 added the format stamp + manifest; bump ONLY for layout
# changes a version-2 reader cannot survive (a new meta key is not one)
CHECKPOINT_FORMAT_VERSION = 2
# the key the stamp hides under inside the meta JSON: load pops it back
# out, so callers' meta round-trips unchanged
_FORMAT_KEY = "__format__"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1] if prefix.endswith("/") else prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-safe write: a temp file in the target's directory, fsynced,
    then ONE atomic os.replace and an fsync of the directory entry — a
    reader (or a restore after the writer was SIGKILLed mid-write, or the
    host lost power) observes either the previous complete file or the
    new complete file, never a torn prefix. Used by the npz checkpoint
    writer below."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(path) + ".tmp."
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dfd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def save_device_checkpoint(path: str, tree: Any, meta: Dict[str, Any]) -> None:
    """Write a nested dict of host (numpy) arrays + JSON-serializable meta.

    The write is ATOMIC (temp file + fsync + os.replace): a host killed
    mid-checkpoint — the exact moment a SIGKILL chaos event or an OOM
    likes to strike, since checkpointing is the longest host-side pause —
    can truncate only the invisible temp file. The previous checkpoint at
    `path` stays intact, so kill→restore always finds a complete file
    instead of one `CheckpointIncompatible` rejects at the worst time."""
    flat = {f"t/{k}": np.asarray(v) for k, v in _flatten(tree).items()}
    stamped = dict(meta)
    stamped[_FORMAT_KEY] = {
        "version": CHECKPOINT_FORMAT_VERSION,
        "manifest": {
            k: [list(v.shape), v.dtype.str] for k, v in flat.items()
        },
    }
    flat["__meta__"] = np.frombuffer(
        json.dumps(stamped).encode("utf-8"), dtype=np.uint8
    )
    # np.savez appends .npz to extensionless string paths; the buffered
    # atomic path must keep that contract for existing callers
    if not path.endswith(".npz"):
        path += ".npz"
    buf = io.BytesIO()
    np.savez_compressed(buf, **flat)
    atomic_write_bytes(path, buf.getvalue())


def _check_format(path: str, fmt: Dict[str, Any],
                  arrays: Dict[str, np.ndarray]) -> None:
    """Validate the stamped format against the ALREADY-DECOMPRESSED
    payload arrays — NpzFile does not cache member reads, so validating
    off a second `data[name]` pass would decompress every array twice
    and double the I/O cost of a kill→restore blackout."""
    version = fmt.get("version")
    if not isinstance(version, int) or version > CHECKPOINT_FORMAT_VERSION:
        raise CheckpointIncompatible(
            f"checkpoint {path!r} was written by a newer build — upgrade "
            "this process or re-checkpoint from the old one",
            found=version, expected=CHECKPOINT_FORMAT_VERSION,
        )
    for name, (shape, dtype) in fmt.get("manifest", {}).items():
        arr = arrays.get(name)
        if arr is None:
            raise CheckpointIncompatible(
                f"checkpoint {path!r} is missing payload {name!r} named "
                "by its manifest — the file is truncated or corrupted",
                found=sorted(arrays)[:8],
                expected=name,
            )
        if list(arr.shape) != list(shape) or arr.dtype.str != dtype:
            raise CheckpointIncompatible(
                f"checkpoint {path!r} payload {name!r} does not match its "
                "manifest — the file is corrupted or was rewritten",
                found=[list(arr.shape), arr.dtype.str],
                expected=[list(shape), dtype],
            )


def load_device_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Read back (tree, meta); arrays are host numpy (the caller moves them
    to its device).

    Raises CheckpointIncompatible on a truncated/corrupted file, a payload
    that disagrees with the stamped manifest, or a format version newer
    than this build. Legacy (unstamped) checkpoints load best-effort."""
    try:
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
            fmt = meta.pop(_FORMAT_KEY, None)
            arrays = {
                k: data[k] for k in data.files if k.startswith("t/")
            }
            if fmt is not None:
                _check_format(path, fmt, arrays)
            flat = {k[2:]: v for k, v in arrays.items()}
    except CheckpointIncompatible:
        raise
    except Exception as exc:
        # BadZipFile / KeyError("__meta__") / JSONDecodeError / OSError /
        # a member that dies mid-decompress: all of them mean "this is
        # not a checkpoint this build can read", which deserves ONE typed
        # operator-facing error instead of five library-specific ones
        raise CheckpointIncompatible(
            f"checkpoint {path!r} is unreadable "
            f"({type(exc).__name__}: {exc}) — truncated, corrupted, or "
            "not a ggrs checkpoint",
        ) from exc
    return _unflatten(flat), meta
