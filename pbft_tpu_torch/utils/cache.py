"""Host-keyed cache location: the port's copy of
``pbft_tpu/utils/cache.py``.

A build cache that moves between hosts (a copied workspace, a shared
volume) must never hand one host another host's artifacts: the kernel
libraries that ``nvcc`` builds for the card are loaded with ``ctypes``,
and a library built against another host's toolkit or CPU is at
best a wasted load and at worst a crash. So a cache directory is keyed by
the host's identity AND its CPU description: a foreign cache lands under
a different key and is simply never read. The cost of a key mismatch is
a cold rebuild, never a crash.

The key folds in (a) a stable host id (``/etc/machine-id``, falling back
to the hostname) and (b) the machine type + CPU model name + feature
flags. Same host, same kernel → same key → warm cache; any move or CPU
change → new key → cold but safe. The verify daemon's ``--cache-dir``
(``pbft_tpu_torch/net/verify_service.py``) roots its kernel build at
``host_keyed_cache_dir(<cache-dir>)``.

This module imports neither torch nor anything of the port: a caller can
compute the cache path before it touches the card.
"""

from __future__ import annotations

import hashlib
import os
import platform


def _cpuinfo_fields(*names: str) -> str:
    """First occurrence of each named /proc/cpuinfo field, joined."""
    found = {n: "" for n in names}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key = line.split(":")[0].strip()
                if key in found and not found[key]:
                    found[key] = line.split(":", 1)[1].strip()
                if all(found.values()):
                    break
    except OSError:
        pass  # non-Linux: machine type + host id still separate real moves
    return "|".join(found[n] for n in names)


def _host_id() -> str:
    """A stable identifier for THIS host (not the workspace)."""
    for path in ("/etc/machine-id", "/var/lib/dbus/machine-id"):
        try:
            with open(path) as fh:
                hid = fh.read().strip()
            if hid:
                return hid
        except OSError:
            continue
    return platform.node()


def host_cache_key() -> str:
    """12-hex digest of host id + machine type + CPU model + features.

    ``PBFT_CACHE_HOST_KEY`` overrides the computed key (tests pin it to
    exercise warm-restart behavior deterministically)."""
    override = os.environ.get("PBFT_CACHE_HOST_KEY")
    if override:
        return override
    cpu = _cpuinfo_fields("model name", "flags", "Features")
    return hashlib.blake2b(
        f"{_host_id()}|{platform.machine()}|{cpu}".encode(), digest_size=6
    ).hexdigest()


def host_keyed_cache_dir(root: str) -> str:
    """<root>/<host_cache_key()>, e.g. cache/a1b2c3d4e5f6."""
    return os.path.join(root, host_cache_key())
