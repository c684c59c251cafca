"""The port's Zenodo data pipeline against the JAX package's: the synthetic fixture v1, the
pickle loader, the 'full' and 'paper' splits through ``resolve_data`` with the mmap cache on
and off, the cache's file format in both directions, ``--no_synthetic``, ``verify_zenodo``,
``inspect_data`` and the entry points on the paper protocol.

Every comparison is exact (``assert_array_equal``, dtypes and shapes too): both packages run
the same float64 numpy arithmetic on the same draws, and the cache holds the bytes it was
given. Each case runs in its own temporary directory, since the entry points resolve the
data under ``./data``. The JAX package's pickles come from pandas, which this machine has.
"""

import numpy as np
import pytest
import torch

from iinsvae_tpu.cli import common as jcommon
from iinsvae_tpu.cli import inspect_data as jinspect
from iinsvae_tpu.config import Config as JConfig
from iinsvae_tpu.data import synthetic as jsynthetic
from iinsvae_tpu.data import verify as jverify
from iinsvae_tpu.data.zenodo import load_pkl_data as jax_load_pkl_data
from iinsvae_tpu.runtime import cache as jcache
from iinsvae_torch.cli import common, evaluate, inspect_data, serve, train_semi
from iinsvae_torch.config import Config
from iinsvae_torch.data import synthetic, verify
from iinsvae_torch.data.pipeline import UWBDataset
from iinsvae_torch.data.zenodo import ZENODO_ENVS, load_pkl_data
from iinsvae_torch.runtime import cache

N = 240  # fixture rows: every room and obstacle drawn, a few hundred bytes a CIR


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("env", ["room_full", "paper", "nlos"])
def test_fixture_v1_is_bit_equal_to_jax(env):
    got = synthetic.synthetic_arrays(N, 3, env, version=1)
    _same(got, jsynthetic.synthetic_arrays(N, 3, env, version=1))
    # version 1 draws no material resonance: its CIRs differ from version 2's
    assert not np.array_equal(got[0], synthetic.synthetic_arrays(N, 3, env)[0])


def test_fixture_path_is_the_name_ensure_dataset_writes(tmp_path):
    root = str(tmp_path / "dataset.pkl")
    for version in (1, 2):
        assert synthetic.fixture_path(root, 64, 5, version) == jsynthetic.ensure_dataset(
            root, n=64, seed=5, version=version)


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    """A JAX-written fixture pickle with two multi-obstacle rows, which every selection but
    room_full leaves out."""
    frame = jsynthetic.synthetic_zenodo_frame(N, seed=4)
    frame.loc[[3, 17], "Obstacles"] = "0000000011"
    path = tmp_path_factory.mktemp("pkl") / "dataset.pkl"
    frame.to_pickle(path)
    return str(path)


@pytest.mark.parametrize("env", ZENODO_ENVS)
def test_load_pkl_data_matches_jax(pickle_path, env):
    _same(load_pkl_data(pickle_path, env, seed=2), jax_load_pkl_data(pickle_path, env, seed=2))


def _configs(name, **kw):
    return Config(dataset_name=name, **kw), JConfig(dataset_name=name, **kw)


CASES = {
    "zenodo full v1": dict(name="zenodo", dataset_env="room_full", fixture_version=1),
    "zenodo paper": dict(name="zenodo", dataset_env="paper", mode="paper"),
    "ewine": dict(name="ewine"),
}


@pytest.mark.parametrize("cached", [True, False], ids=["cache", "no_cache"])
@pytest.mark.parametrize("case", list(CASES))
def test_resolve_data_matches_jax(tmp_path, monkeypatch, case, cached):
    kw = dict(CASES[case])
    cfg, jcfg = _configs(kw.pop("name"), synthetic_n=N, seed=1, data_cache=cached, **kw)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jcommon.resolve_data(jcfg)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    got = common.resolve_data(cfg)
    _same(got[0] + got[1], want[0] + want[1])
    files = sorted((tmp_path / "port").rglob("*.iinsc"))
    assert len(files) == cached
    if cached:  # the second resolution reads the cache, which holds the same arrays
        def no_split(*a, **k):
            raise AssertionError("a cache hit assembled the split again")
        monkeypatch.setattr(common, "err_mitigation_dataset", no_split)
        again = common.resolve_data(cfg)
        _same(again[0] + again[1], want[0] + want[1])
        assert not again[0][0].flags.writeable  # a view of the mapping
    if cfg.mode == "paper":  # the medium room is the test split
        assert 0 < got[1][0].shape[0] < got[0][0].shape[0]


ARRAYS = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
          "f64": np.linspace(-1, 1, 5),
          "i64": np.arange(24, dtype=np.int64).reshape(2, 3, 2, 2) - 9}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_reads_across_packages(tmp_path, writer):
    ours, theirs = tmp_path / "port.iinsc", tmp_path / "jax.iinsc"
    assert cache.write_cache(str(ours), ARRAYS) and jcache.write_cache(str(theirs), ARRAYS)
    assert ours.read_bytes() == theirs.read_bytes()  # the same layout, byte for byte
    path = str(ours if writer == "port" else theirs)
    for read in (cache.read_cache, jcache.read_cache):
        got = read(path)
        assert list(got) == list(ARRAYS)
        _same(list(got.values()), list(ARRAYS.values()))


def test_cache_misses_and_keys(tmp_path):
    assert cache.read_cache(str(tmp_path / "absent.iinsc")) is None
    bad = tmp_path / "bad.iinsc"
    bad.write_bytes(b"IINSC01\0" + b"\xff" * 40)  # a record table out of bounds
    assert cache.read_cache(str(bad)) is None
    src = tmp_path / "src.csv"
    src.write_text("1")
    key = cache.cache_key(str(src), env="nlos", seed=0)
    assert key == jcache.cache_key(str(src), env="nlos", seed=0)
    assert key != cache.cache_key(str(src), env="nlos", seed=1)


@pytest.mark.parametrize("name", ["zenodo", "ewine"])
def test_no_synthetic_raises_in_both_packages(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)
    cfg, jcfg = _configs(name, allow_synthetic=False, data_root=str(tmp_path / "none.pkl"))
    for resolve, c in ((common.resolve_data, cfg), (jcommon.resolve_data, jcfg)):
        with pytest.raises(FileNotFoundError):
            resolve(c)
    assert not list(tmp_path.rglob("*"))


@pytest.mark.parametrize("case", ["fixture", "broken", "absent"])
def test_verify_zenodo_matches_jax(tmp_path, case):
    path = tmp_path / "dataset.pkl"
    if case != "absent":
        frame = jsynthetic.synthetic_zenodo_frame(60, seed=0)
        if case == "broken":
            frame.at[2, "CIR"] = frame.at[2, "CIR"][:100]
            frame.loc[4, "Room"] = 7
            frame.loc[5, "Obstacles"] = "01x"
            frame.loc[6, "Error"] = np.nan
        frame.to_pickle(path)
    got, want = verify.verify_zenodo(str(path)), jverify.verify_zenodo(str(path))
    assert got == want
    assert got["ok"] == (case == "fixture")


def test_uwbdataset_items_and_device_batches():
    train = tuple(np.asarray(a, np.float32) for a in synthetic.synthetic_arrays(20, 0)[:3])
    ds = UWBDataset(train)
    assert len(ds) == 20 and ds[23]["CIR"].shape == (157,)
    np.testing.assert_array_equal(ds[23]["Err"], train[1][3])
    on = ds.as_device_batches(torch.device("cpu"))
    assert set(on) == {"cir", "err", "label"} and on["cir"].dtype == torch.float32
    np.testing.assert_array_equal(on["label"].numpy(), train[2])
    assert sum(len(b["CIR"]) for b in ds.batches(8, shuffle=True)) == 20


def test_inspect_data_prints_the_split_and_plots(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    flags = ["--dataset_env", "paper", "--mode", "paper", "--synthetic_n", str(N),
             "--out_dir", str(tmp_path / "out")]
    train, test = inspect_data.main(flags)
    out = capsys.readouterr().out
    jtrain, jtest = jinspect.main(flags)
    _same(train + test, jtrain + jtest)
    assert f"train: cir {train[0].shape}" in out and "class 0 (metal)" in out
    assert list((tmp_path / "out").glob("zenodo_sample_*.png"))


def test_inspect_data_verify_data_reports_and_exits(tmp_path, capsys):
    path = tmp_path / "dataset.pkl"
    jsynthetic.synthetic_zenodo_frame(60, seed=0).to_pickle(path)
    for root, code in ((path, 0), (tmp_path / "absent.pkl", 1)):
        with pytest.raises(SystemExit) as e:
            inspect_data.main(["--verify_data", "--data_root", str(root)])
        assert e.value.code == code
    out = capsys.readouterr().out
    assert f"[verify_data] zenodo {path}: OK" in out and "row count 60" in out
    assert "absent.pkl: FAILED" in out and "10.5281/zenodo.4290069" in out


def test_paper_protocol_entry_points_on_cpu(tmp_path, monkeypatch, capsys):
    """train_semi, evaluate and serve on the paper protocol's split (the 2-D model in
    bfloat16 is the protocol's; the 1-D model keeps this small), 4 classes."""
    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--mode", "paper", "--dataset_env", "paper", "--synthetic_n",
             "400", "--batch_size", "50", "--supervision_rate", "1.0", "--sample_interval", "0",
             "--checkpoint_interval", "-1"]
    state, final = train_semi.main(flags + ["--n_epochs", "1"])
    assert state.model.num_classes == 4 and np.isfinite(final["rmse"])
    assert evaluate.main(flags + ["--test_epoch", "1"]) == final
    serve.main(flags + ["--epoch", "1", "--selftest_n", "5", "--serve_batch", "4"])
    out = capsys.readouterr().out
    assert "self-test ok: 5 requests through the server" in out
    assert list(tmp_path.glob("saved_models/paper_mode_paper/*/epoch_1/state.pt"))
