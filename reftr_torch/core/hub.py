"""Checkpoints by URL, with a local cache (port of reftr_tpu/core/hub.py).

The reference resumes from a URL through ``torch.hub.
load_state_dict_from_url`` (main_vg.py:307-309); its released RefTR
checkpoints are URLs (README.md:86-91). A download lands in
``$REFTR_CACHE_DIR`` (default ``~/.cache/reftr_torch/checkpoints``) under
a hash of the URL and its basename, so a later run reuses the file, as
torch.hub's cache does. A file name that embeds a hash fragment
(``name-<8+ hex>.ext``, torch.hub's convention) must match the file's
sha256, on download and again on each cache hit; any other file's sha256
is logged.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import tempfile
import urllib.parse
import urllib.request


def cache_dir() -> str:
    return os.environ.get(
        "REFTR_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "reftr_torch",
                     "checkpoints"))


def is_url(path: str) -> bool:
    return path.startswith(("http://", "https://"))


_HASH_RE = re.compile(r"-([a-f0-9]{8,64})\.")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _verify_or_log(path: str, name: str, progress_fn) -> bool:
    """Check a file against the hash fragment of its name, if it has one,
    and log its sha256. Returns whether it passed."""
    digest = _sha256(path)
    m = _HASH_RE.search(name)
    if m and not digest.startswith(m.group(1)):
        progress_fn(f"hash mismatch for {name}: file sha256 {digest} does "
                    f"not start with {m.group(1)}")
        return False
    progress_fn(f"checkpoint {name} sha256: {digest}")
    return True


def download_checkpoint(url: str, progress_fn=print) -> str:
    """Fetch ``url`` into the cache (once) and return the local path."""
    name = os.path.basename(urllib.parse.urlparse(url).path) or "checkpoint"
    key = hashlib.sha256(url.encode()).hexdigest()[:16]
    dest = os.path.join(cache_dir(), f"{key}-{name}")
    if os.path.isfile(dest):
        # a hash-named entry is checked again: a corrupt one is fetched anew
        if _HASH_RE.search(name) is None or \
                _verify_or_log(dest, name, progress_fn):
            return dest
        os.unlink(dest)
    os.makedirs(cache_dir(), exist_ok=True)
    progress_fn(f"Downloading checkpoint {url} -> {dest}")
    # into a temporary file, renamed when whole: a run killed mid-download
    # leaves no truncated file for a later run to trust
    fd, tmp = tempfile.mkstemp(dir=cache_dir(), suffix=".part")
    os.close(fd)
    try:
        # a timeout per socket read, not per download: a dead server fails
        # in a minute
        with urllib.request.urlopen(url, timeout=60) as r, \
                open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        if not _verify_or_log(tmp, name, progress_fn):
            raise IOError(f"downloaded checkpoint {url} failed its "
                          "embedded-hash integrity check")
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return dest
