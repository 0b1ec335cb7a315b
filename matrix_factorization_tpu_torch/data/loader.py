"""Rating-file loading and the port's native host library.

Counterpart of ``matrix_factorization_tpu/data/loader.py``.
``load_ratings_csv`` parses a (user, item, rating) CSV into dense int32
ids, float32 ratings and the id vocabularies, the input format of every
trainer. Files with numeric ids go through the threaded C++ parser of
``csrc/host_loader.cpp``, which also encodes ids densely in first-seen
order (as :class:`core.ids.IdVocab` does); files with string ids, or with
a line the parser cannot read, go through pandas. The outputs, ``backend``
included, equal the JAX package's for the same file.

``host_lib`` is the ``ctypes`` binding of ``host_loader.cpp``, made by
``ops/_build.py`` from the table here and built at first use; the packs
of ``ops/segment_sgd.py``, ``ops/ials.py``, ``ops/sparse_gram.py`` and
``models/cf_topk.py`` call its counting sorts. A failed build raises: no
path switches to numpy on its own.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

from matrix_factorization_tpu_torch.ops import _build

_c, _ll, _i32 = ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int
_dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_llp = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_LIB = _build.Library("host_loader", {
    "mf_count_rows": ([_c, _ll, _i32], _ll),
    "mf_parse_numeric_csv": ([_c, _ll, _i32, _i32, _i32, _i32, _ll, _dp, _dp, _fp,
                              _i32], _ll),
    "mf_dense_encode": ([_dp, _ll, _ip, _dp], _ll),
    "mf_find_duplicate_pair": ([_dp, _dp, _ll], _ll),
    "mf_entity_counts": ([_ip, _ll, _i32, _ip], None),
    "mf_pack_grouped": ([_ip, _ip, _fp, _ll, _ip, _ip, _ip, _llp, _ip, _fp, _fp,
                         _ip], None),
    "mf_sort_ranges": ([_ip, _ip, _fp, _fp, _llp, _llp, _i32, _i32, _i32, _i32],
                       None),
    "mf_argsort_ranges": ([_ip, _llp, _llp, _i32, _i32, _ip, _ip, _i32], None),
    "mf_gather_rows": ([_ip, _ip, _fp, _llp, _ll, _ip, _ip, _fp, _i32], None),
    "mf_sort_pairs_by_key": ([_ip, _ip, _fp, _ll, _i32, _ip, _fp], None),
    "mf_sort_triple_by_key": ([_ip, _ip, _ip, _fp, _ll, _i32, _ip, _ip, _fp], None),
    "mf_lexsort_pair": ([_ip, _ip, _fp, _ll, _i32, _i32, _ip, _fp], None),
})


def native_threads() -> int:
    """Threads of the native passes: the host's cores, at most 16."""
    return min(16, os.cpu_count() or 1)


def host_lib() -> ctypes.CDLL:
    """The bound host library (``csrc/host_loader.cpp``), built on first
    use; raises ``RuntimeError`` when it cannot be built. Its entry points
    return counts or nothing, and are called raw."""
    return _LIB.cdll()


class LoadedRatings(NamedTuple):
    user_ids: np.ndarray  # int32 dense
    item_ids: np.ndarray  # int32 dense
    ratings: np.ndarray  # float32
    user_uniques: np.ndarray  # raw ids in dense order
    item_uniques: np.ndarray
    backend: str  # 'native' | 'pandas'


def _native_load(path: Path, has_header: bool, cols: Tuple[int, int, int],
                 check_duplicates: bool) -> Optional[LoadedRatings]:
    """The native parse, or None when the file has no data row or a line
    the parser cannot read (non-numeric ids, a malformed line)."""
    lib = host_lib()
    blob = path.read_bytes()
    if not blob:
        return None
    n = lib.mf_count_rows(blob, len(blob), int(has_header))
    if n <= 0:
        return None
    users = np.empty(n, np.float64)
    items = np.empty(n, np.float64)
    ratings = np.empty(n, np.float32)
    got = lib.mf_parse_numeric_csv(
        blob, len(blob), int(has_header), cols[0], cols[1], cols[2], n,
        users, items, ratings, native_threads())
    if got <= 0:
        return None
    users, items, ratings = users[:got], items[:got], ratings[:got]
    if check_duplicates and lib.mf_find_duplicate_pair(users, items, got) >= 0:
        raise ValueError("Duplicate user-item ratings in matrix")
    u_codes = np.empty(got, np.int32)
    u_uniq = np.empty(got, np.float64)
    nu = lib.mf_dense_encode(users, got, u_codes, u_uniq)
    i_codes = np.empty(got, np.int32)
    i_uniq = np.empty(got, np.float64)
    ni = lib.mf_dense_encode(items, got, i_codes, i_uniq)
    return LoadedRatings(u_codes, i_codes, ratings, u_uniq[:nu], i_uniq[:ni],
                         "native")


def _pandas_load(path: Path, has_header: bool, cols: Tuple[int, int, int],
                 check_duplicates: bool) -> LoadedRatings:
    import pandas as pd

    df = pd.read_csv(path, header=0 if has_header else None)
    cu, ci, cr = (df.columns[c] for c in cols)
    users = df[cu].to_numpy()
    items = df[ci].to_numpy()
    ratings = df[cr].to_numpy(np.float32)
    if check_duplicates and pd.DataFrame({"u": users, "i": items}).duplicated().any():
        raise ValueError("Duplicate user-item ratings in matrix")
    # first-seen order (np.unique would sort; pd.factorize keeps the order)
    u_codes, u_uniq = pd.factorize(users, use_na_sentinel=False)
    i_codes, i_uniq = pd.factorize(items, use_na_sentinel=False)
    return LoadedRatings(u_codes.astype(np.int32), i_codes.astype(np.int32),
                         ratings, np.asarray(u_uniq), np.asarray(i_uniq),
                         "pandas")


def load_ratings_csv(
    path: os.PathLike,
    has_header: bool = True,
    cols: Tuple[int, int, int] = (0, 1, 2),
    check_duplicates: bool = True,
    force_backend: Optional[str] = None,
) -> LoadedRatings:
    """Load and dense-encode a rating CSV.

    ``cols`` are the (user, item, rating) column positions. Numeric ids
    are parsed natively; string ids and lines the native parser cannot
    read go to pandas (``force_backend='native'`` raises ``RuntimeError``
    for them instead, ``'pandas'`` always reads with pandas). Duplicate
    (user, item) pairs raise ``ValueError`` when ``check_duplicates``."""
    if force_backend not in (None, "native", "pandas"):
        raise ValueError(f"unknown backend {force_backend!r}")
    path = Path(path)
    if force_backend != "pandas":
        out = _native_load(path, has_header, cols, check_duplicates)
        if out is not None:
            return out
        if force_backend == "native":
            raise RuntimeError(
                f"the native parser cannot read {path} (non-numeric ids or a "
                "malformed line)")
    return _pandas_load(path, has_header, cols, check_duplicates)
