"""The port's native host library (``csrc/host_loader.cpp``): it builds,
the one binding of native code (``ops/_build.py``) checks and counts its
calls, each helper equals its numpy version, the SGD and ALS packs are byte-equal
native vs numpy vs the JAX package's, and ``load_ratings_csv`` equals the
JAX loader."""

import ctypes
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from matrix_factorization_tpu.data import loader as jloader
from matrix_factorization_tpu.ops import ials as jials
from matrix_factorization_tpu.ops import segment_sgd as jsgd
from matrix_factorization_tpu_torch.data import loader
from matrix_factorization_tpu_torch.ops import _build, ials
from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

ORDERS = ["shuffle", "item", "user", "block", "auto"]
REPO = Path(__file__).resolve().parents[1]


def _ratings(rng, n, n_users, n_items, half_stars=True):
    u = rng.integers(0, n_users, n).astype(np.int32)
    i = rng.integers(0, n_items, n).astype(np.int32)
    if half_stars:
        r = (rng.integers(1, 11, n) * 0.5).astype(np.float32)
    else:
        r = rng.uniform(0.5, 5, n).astype(np.float32)
    return u, i, r


def test_host_library_builds_into_a_hashed_name():
    lib = loader.host_lib()
    target = _build._target("host_loader")
    assert target.exists() and target.parent == _build.BUILD_DIR
    assert target.name.startswith("libhost_loader-")
    assert loader.host_lib() is lib
    for name in ("mf_parse_numeric_csv", "mf_pack_grouped", "mf_sort_ranges",
                 "mf_lexsort_pair", "mf_sort_triple_by_key"):
        assert getattr(lib, name).argtypes


def test_concurrent_builds_are_safe(tmp_path):
    """Processes that build the same source at once each compile to their
    own temporary and rename it into place: every one loads a whole
    library and none fails."""
    script = (
        "import sys\nfrom pathlib import Path\n"
        "from matrix_factorization_tpu_torch.ops import _build\n"
        f"_build.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "lib = _build.load('host_loader')\n"
        "print(lib.mf_count_rows(b'a\\nb\\nc\\n', 6, 1))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [o[1] for o in outs]
    assert [o[0].strip() for o in outs] == ["2"] * 4
    assert len(list(tmp_path.glob("*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build broken.cpp"):
        _build.load("broken")
    assert not list((tmp_path / "build").glob("*"))


class _StandIn:
    """A loaded library in place of a build: ``mf_standin_run`` returns its
    argument as the status, ``mf_standin_error`` names the status."""

    @staticmethod
    def mf_standin_run(rc):
        return rc

    @staticmethod
    def mf_standin_count():
        return 7

    @staticmethod
    def mf_standin_error(rc):
        return f"status {rc} in the stand-in".encode()


def test_checked_call_raises_counts_and_refuses(monkeypatch):
    """The checked call: a non-zero return raises with the entry's name and
    the library's message and counts nothing; a zero return counts one
    launch of that entry and of no other; an entry point outside the table
    is refused, and so is a checked call of one that returns no status."""
    monkeypatch.setattr(_build, "LIBRARIES", dict(_build.LIBRARIES))
    lib = _build.Library("standin", {
        "mf_standin_run": ([ctypes.c_int], ctypes.c_int),
        "mf_standin_count": ([], ctypes.c_longlong),
    }, error="mf_standin_error")
    lib._lib = _StandIn()  # loaded: nothing is built
    counts = dict(_build._launches)
    with pytest.raises(RuntimeError, match="mf_standin_run failed: status 3 in the stand-in"):
        lib("mf_standin_run", 3)
    assert _build.launches("mf_standin_run") == 0 and _build._launches == counts
    lib("mf_standin_run", 0)
    lib("mf_standin_run", 0)
    assert _build.launches("mf_standin_run") == 2
    assert {k: v for k, v in _build._launches.items() if counts.get(k) != v} == {
        "mf_standin_run": 2}
    for refused in (lambda: lib("mf_standin_other", 0),
                    lambda: lib.fn("mf_standin_other"),
                    lambda: lib("mf_standin_count"),
                    lambda: _build.launches("mf_standin_other")):
        with pytest.raises(ValueError):
            refused()
    assert lib.fn("mf_standin_count")() == 7
    _build.reset_launches("mf_standin_run")
    assert _build.launches("mf_standin_run") == 0 and _build._launches == counts


def test_counting_sorts_equal_numpy():
    rng = np.random.default_rng(1)
    n, U, I = 50_000, 900, 400
    u, i, r = _ratings(rng, n, U, I, half_stars=False)
    lib = loader.host_lib()
    # sort_stream_by_key: mf_sort_triple_by_key
    got = sgd.sort_stream_by_key(u, u, i, r, U)
    want = sgd.sort_stream_by_key(u, u, i, r, U, native=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # the per-range sort, in place
    starts = np.array([0, 7, 20_000, 20_001], np.int64)
    ends = np.array([7, 20_000, 20_001, n], np.int64)
    cols = [(u.copy(), i.copy(), r.copy(), r[::-1].copy()) for _ in range(2)]
    for key_is_item in (False, True):
        sgd._sort_ranges(*cols[0], starts, ends, key_is_item, native=True)
        sgd._sort_ranges(*cols[1], starts, ends, key_is_item, native=False)
        for a, b in zip(*cols):
            np.testing.assert_array_equal(a, b)
    # the per-batch argsort
    sec = u[:49_152].reshape(12, 4096)
    for a, b in zip(sgd._argsort_batches(sec, True), sgd._argsort_batches(sec, False)):
        np.testing.assert_array_equal(a, b)
    # sparse-gram stream and CF CSR sorts
    i_s, r_s = np.empty(n, np.int32), np.empty(n, np.float32)
    lib.mf_sort_pairs_by_key(u, i, r, n, U, i_s, r_s)
    order = np.argsort(u, kind="stable")
    np.testing.assert_array_equal(i_s, i[order])
    np.testing.assert_array_equal(r_s, r[order])
    lib.mf_lexsort_pair(u, i, r, n, U, I, i_s, r_s)
    order = np.lexsort((i, u))
    np.testing.assert_array_equal(i_s, i[order])
    np.testing.assert_array_equal(r_s, r[order])
    # entity counts
    counts = ials._entity_counts(i, I)
    np.testing.assert_array_equal(counts, np.bincount(i, minlength=I))


def _pack_arrays(p):
    return {f.name: getattr(p, f.name).numpy()
            for f in dataclasses.fields(p) if hasattr(getattr(p, f.name), "numpy")}


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", ["pads", "no-shuffle", "unaggregated", "wide-ids"])
def test_pack_native_equals_numpy_and_jax(order, case):
    """Every array of the pack byte-equal across the three packs; the
    last batch carries pads (n is not a multiple of bs)."""
    rng = np.random.default_rng(len(order))
    n, U, I, bs = 6_001, 300, 170, 512
    if case == "wide-ids":
        n, U, I, bs = 30_000, 90_000, 700, 4096
    u, i, r = _ratings(rng, n, U, I, half_stars=case != "pads")
    kw = dict(order=order, shuffle_seed=None if case == "no-shuffle" else 5,
              aggregate=case != "unaggregated")
    nat = sgd.pack_ratings(u, i, r, bs, device="cpu", **kw)
    ref = sgd.pack_ratings(u, i, r, bs, device="cpu", native=False, **kw)
    want = jsgd.pack_ratings(u, i, r, bs, agg_min_gain=-1.0, **kw)
    a, b = _pack_arrays(nat), _pack_arrays(ref)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        # the JAX pack drops the secondary argsort where its tile cost
        # model finds no tile shape (ids spread wider than c_max)
        if getattr(want, name) is not None:
            np.testing.assert_array_equal(a[name], np.asarray(getattr(want, name)),
                                          err_msg=name)
        else:
            assert case == "wide-ids" and name.startswith("sec_")
    assert nat.primary == ref.primary == want.primary
    assert nat.n_real == want.n_real == n


@pytest.mark.parametrize("order", ["shuffle", "item", "user", "block"])
@pytest.mark.parametrize("side", ["user", "item"])
def test_pack_native_rejects_negative_ids(order, side):
    """The native counting sorts index a count array by the id: a negative
    id raises before it reaches them."""
    rng = np.random.default_rng(11)
    u, i, r = _ratings(rng, 2_000, 50, 40)
    (u if side == "user" else i)[123] = -1
    with pytest.raises(ValueError, match="sort keys"):
        sgd.pack_ratings(u, i, r, 256, order=order, device="cpu")


def test_sort_stream_by_key_rejects_keys_out_of_range():
    u, i, r = _ratings(np.random.default_rng(12), 100, 10, 10)
    for key, n_keys in ((i, 5), (i - 1, 10)):
        with pytest.raises(ValueError, match="sort keys"):
            sgd.sort_stream_by_key(key, u, i, r, n_keys)


def _grouped(g):
    return [t.numpy() for t in g]


def test_als_packs_native_equal_numpy_and_jax():
    rng = np.random.default_rng(3)
    U, I = 400, 250
    u, i, r = _ratings(rng, 20_000, U, I)
    u[:600] = 7  # one heavy user: its own bucket
    # group_by_entity (one length L for all entities)
    nat = ials.group_by_entity(u, i, r, U + 3, device="cpu")
    ref = ials.group_by_entity(u, i, r, U + 3, device="cpu", native=False)
    want = jials.group_by_entity(u, i, r, U + 3)
    for a, b, c in zip(_grouped(nat), _grouped(ref), want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    # the bucketed packs, small row budget so that buckets chunk
    for mbr in (4_000_000, 2_048):
        for ids, other, n_ent in ((u, i, U), (i, u, I)):
            nat = ials.group_by_entity_bucketed(ids, other, r, n_ent, mbr, device="cpu")
            ref = ials.group_by_entity_bucketed(ids, other, r, n_ent, mbr, device="cpu",
                                                native=False)
            want = jials.group_by_entity_bucketed(ids, other, r, n_ent, mbr)
            assert len(nat) == len(ref) == len(want) > 1
            for bn, br, bw in zip(nat, ref, want):
                for a, b, c in zip(_grouped(bn), _grouped(br), bw):
                    np.testing.assert_array_equal(a, b)
                    np.testing.assert_array_equal(a, np.asarray(c))
        both = ials.group_both_sides_bucketed(u, i, r, U, I, mbr, device="cpu")
        jboth = jials.group_both_sides_bucketed(u, i, r, U, I, mbr)
        for side, jside in zip(both, jboth):
            for bn, bw in zip(side, jside):
                for a, c in zip(_grouped(bn), bw):
                    np.testing.assert_array_equal(a, np.asarray(c))


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    n = 5000
    df = pd.DataFrame({
        "userId": rng.integers(0, 200, n),
        "movieId": rng.integers(0, 300, n),
        "rating": np.round(rng.uniform(0.5, 5.0, n) * 2) / 2,
        "timestamp": rng.integers(1e9, 2e9, n),
    }).drop_duplicates(subset=["userId", "movieId"])
    path = tmp_path_factory.mktemp("csv") / "ratings.csv"
    df.to_csv(path, index=False)
    return path, df


def _assert_same_load(got, want):
    assert got.backend == want.backend
    for name in ("user_ids", "item_ids", "ratings", "user_uniques", "item_uniques"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("backend", [None, "native", "pandas"])
def test_load_ratings_csv_equals_jax(csv_file, backend):
    path, df = csv_file
    got = loader.load_ratings_csv(path, force_backend=backend)
    _assert_same_load(got, jloader.load_ratings_csv(path, force_backend=backend))
    assert got.backend == (backend or "native")
    np.testing.assert_array_equal(got.user_uniques[got.user_ids].astype(np.int64),
                                  df["userId"].to_numpy())


@pytest.mark.parametrize("text,kw,backend", [
    ("user_id,item_id,rating\nu1,i1,3.0\nu2,i2,2.0\nu1,i2,1\n", {}, "pandas"),
    ("7,1,9.5,4.5\n8,2,9.5,3.0\n\n", {"has_header": False, "cols": (0, 1, 3)},
     "native"),
    ("a,b,c\n1,2,3.5\n4,x5,2.0\n", {}, "pandas"),
    ("a,b,c\n1,2,1e0\n3,2,2.5\n", {}, "native"),
], ids=["string-ids", "header-less-columns", "malformed-line", "exponent"])
def test_load_ratings_csv_files_equal_jax(tmp_path, text, kw, backend):
    path = tmp_path / "r.csv"
    path.write_text(text)
    got = loader.load_ratings_csv(path, **kw)
    assert got.backend == backend
    _assert_same_load(got, jloader.load_ratings_csv(path, **kw))


def test_load_ratings_csv_duplicates_and_backends(tmp_path):
    path = tmp_path / "dup.csv"
    path.write_text("user_id,item_id,rating\n1,2,3.0\n4,5,2.0\n1,2,4.0\n")
    for backend in ("native", "pandas"):
        with pytest.raises(ValueError, match="Duplicate"):
            loader.load_ratings_csv(path, force_backend=backend)
    assert len(loader.load_ratings_csv(path, check_duplicates=False).ratings) == 3
    (tmp_path / "s.csv").write_text("u,i,r\nu1,i1,3.0\n")
    with pytest.raises(RuntimeError, match="native parser"):
        loader.load_ratings_csv(tmp_path / "s.csv", force_backend="native")
    with pytest.raises(ValueError, match="backend"):
        loader.load_ratings_csv(path, force_backend="arrow")


def test_all_unique_ids(tmp_path):
    n = 6000
    pd.DataFrame({"userId": np.arange(n), "movieId": np.arange(n)[::-1],
                  "rating": np.full(n, 3.0)}).to_csv(tmp_path / "u.csv", index=False)
    got = loader.load_ratings_csv(tmp_path / "u.csv")
    assert got.backend == "native" and len(got.user_uniques) == n
    _assert_same_load(got, jloader.load_ratings_csv(tmp_path / "u.csv"))
