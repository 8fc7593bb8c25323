"""ctypes bindings of the native data runtime (port of
reftr_tpu/data/native.py:1-256).

The C++ sources under ``csrc/`` (WordPiece and byte-level BPE tokenizers,
the bilinear resize, HSV jitter and canvas packing, and the LSAP solver)
are copies of the JAX package's. ``build`` compiles them with ``g++`` into
``build/libreftr_data-<hash>.so``, the hash covering the sources and the
flags, at first use; nothing is built when this module is imported. The
flags are the JAX package's Makefile's: with others GCC may contract the
resize's weights into FMAs in another way and a resized pixel can round
one step apart. All functions take and return numpy arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native",
             "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cpp"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libreftr_data-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into one library unless it is already built."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}"
                       f".tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {CSRC} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    # name: (restype, argtypes)
    "rtok_create": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int]),
    "rtok_free": (None, [ctypes.c_void_p]),
    "rtok_vocab_size": (ctypes.c_int, [ctypes.c_void_p]),
    "rtok_token_id": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p]),
    "rtok_encode": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_int, _I32P, _I32P,
                                   _I32P]),
    "rbpe_create": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p]),
    "rbpe_free": (None, [ctypes.c_void_p]),
    "rbpe_vocab_size": (ctypes.c_int, [ctypes.c_void_p]),
    "rbpe_pad_id": (ctypes.c_int, [ctypes.c_void_p]),
    "rbpe_bos_id": (ctypes.c_int, [ctypes.c_void_p]),
    "rbpe_eos_id": (ctypes.c_int, [ctypes.c_void_p]),
    "rbpe_encode": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_int, _I32P, _I32P,
                                   _I32P]),
    "rimg_resize_bilinear": (None, [_U8P, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, _U8P, ctypes.c_int,
                                    ctypes.c_int]),
    "rimg_hsv_jitter": (None, [_U8P, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_float]),
    "rimg_pack_canvas": (None, [_U8P, ctypes.c_int, ctypes.c_int, _U8P,
                                ctypes.c_int, ctypes.c_int]),
    "lsap_solve": (ctypes.c_int, [ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_int, ctypes.c_int, _I32P]),
}


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def resize_bilinear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Antialiased bilinear resize (Pillow's). img: [H, W, C] uint8."""
    lib = get_lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    oh, ow = out_hw
    out = np.empty((oh, ow, c), np.uint8)
    lib.rimg_resize_bilinear(_u8ptr(img), h, w, c, _u8ptr(out), oh, ow)
    return out


def hsv_jitter(img: np.ndarray, s_factor: float, v_factor: float
               ) -> np.ndarray:
    """Saturation and value jitter of a copy; img: [H, W, 3] uint8 RGB."""
    lib = get_lib()
    out = np.ascontiguousarray(img, dtype=np.uint8).copy()
    h, w, _ = out.shape
    lib.rimg_hsv_jitter(_u8ptr(out), h, w, float(s_factor), float(v_factor))
    return out


def pack_canvas(img: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Paste [h, w, 3] uint8 at the canvas's top left, zero the rest."""
    lib = get_lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    ch, cw = canvas_hw
    if h > ch or w > cw:
        raise ValueError(f"image {img.shape} does not fit canvas {canvas_hw}")
    out = np.empty((ch, cw, 3), np.uint8)
    lib.rimg_pack_canvas(_u8ptr(img), h, w, _u8ptr(out), ch, cw)
    return out


def lsap(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment of cost [n, m], n <= m: the column of each row
    (scipy.optimize.linear_sum_assignment's col_ind for sorted rows)."""
    lib = get_lib()
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    out = np.empty(n, np.int32)
    rc = lib.lsap_solve(cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        n, m, out.ctypes.data_as(_I32P))
    if rc != 0:
        raise ValueError(f"lsap_solve failed (n={n}, m={m}; need n <= m)")
    return out


def _encode(encode_fn, handle, pad_id: int, text: str, max_length: int,
            pad: bool):
    """(ids [max_length] i32, attention mask [max_length] i32, offsets
    [max_length, 2] i32) of ``text`` with the special tokens, truncated
    and padded to ``max_length`` (cut to the tokens without ``pad``)."""
    cap = max(max_length, 4)
    ids = np.zeros(cap, np.int32)
    st = np.zeros(cap, np.int32)
    en = np.zeros(cap, np.int32)
    n = encode_fn(handle, text.encode(), 1, max_length,
                  ids.ctypes.data_as(_I32P), st.ctypes.data_as(_I32P),
                  en.ctypes.data_as(_I32P))
    mask = np.zeros(max_length, np.int32)
    mask[:n] = 1
    out_ids = np.full(max_length, pad_id, np.int32)
    out_ids[:n] = ids[:n]
    offsets = np.zeros((max_length, 2), np.int32)
    offsets[:n, 0] = st[:n]
    offsets[:n, 1] = en[:n]
    if not pad:
        return out_ids[:n], mask[:n], offsets[:n]
    return out_ids, mask, offsets


def char_to_token(offsets: np.ndarray, mask: np.ndarray,
                  char_pos: int) -> Optional[int]:
    """The token whose character span holds ``char_pos``, or None; special
    tokens have (0, 0) spans and never match (the HF fast tokenizers'
    behaviour the reference relies on)."""
    for i in range(len(offsets)):
        if not mask[i]:
            break
        s, e = int(offsets[i, 0]), int(offsets[i, 1])
        if s != e and s <= char_pos < e:
            return i
    return None


class WordPieceTokenizer:
    """BERT WordPiece tokenizer with character offsets: encode with [CLS]
    and [SEP], pad or truncate to max_length, and char_to_token."""

    def __init__(self, vocab_path: str, do_lower_case: bool = True):
        lib = get_lib()
        self._lib = lib
        self._h = lib.rtok_create(vocab_path.encode(), int(do_lower_case))
        if not self._h:
            raise FileNotFoundError(vocab_path)
        self.pad_id = lib.rtok_token_id(self._h, b"[PAD]")
        self.cls_id = lib.rtok_token_id(self._h, b"[CLS]")
        self.sep_id = lib.rtok_token_id(self._h, b"[SEP]")
        self.unk_id = lib.rtok_token_id(self._h, b"[UNK]")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rtok_free(self._h)
            self._h = None

    @property
    def vocab_size(self) -> int:
        return self._lib.rtok_vocab_size(self._h)

    def token_id(self, token: str) -> int:
        return self._lib.rtok_token_id(self._h, token.encode())

    def encode(self, text: str, max_length: int, pad: bool = True):
        return _encode(self._lib.rtok_encode, self._h, self.pad_id, text,
                       max_length, pad)

    char_to_token = staticmethod(char_to_token)


class ByteLevelBPETokenizer:
    """RoBERTa's byte-level BPE from vocab.json and merges.txt, with the
    surface of WordPieceTokenizer (<s> and </s> as the special tokens)."""

    def __init__(self, vocab_json: str, merges_txt: str):
        lib = get_lib()
        self._lib = lib
        self._h = lib.rbpe_create(vocab_json.encode(), merges_txt.encode())
        if not self._h:
            raise FileNotFoundError((vocab_json, merges_txt))
        self.pad_id = lib.rbpe_pad_id(self._h)
        self.cls_id = lib.rbpe_bos_id(self._h)
        self.sep_id = lib.rbpe_eos_id(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rbpe_free(self._h)
            self._h = None

    @property
    def vocab_size(self) -> int:
        return self._lib.rbpe_vocab_size(self._h)

    def encode(self, text: str, max_length: int, pad: bool = True):
        return _encode(self._lib.rbpe_encode, self._h, self.pad_id, text,
                       max_length, pad)

    char_to_token = staticmethod(char_to_token)
