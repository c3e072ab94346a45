"""The port's storage backends (msm_tpu_torch/io/storage.py) against the
JAX package's: the local layout, seed-rotated accounts, the HTTP transport
against an in-process object store (round trip, retries, giving up, fast
failure on 4xx, the signed handshake and read-back), keypair loading, and
the same keys and bytes as msm_tpu.io.storage for the same arrays."""

import os

import numpy as np
import pytest

from msm_tpu.io import storage as jstorage
from msm_tpu_torch import config as cfg
from msm_tpu_torch.errors import KeypairError
from msm_tpu_torch.io import storage as tstorage
from msm_tpu_torch.io.npy import AsyncGridWriter, load_complex_pair
from msm_tpu_torch.io.storage import (
    DirectoryTransport,
    HttpTransport,
    LocalNpyBackend,
    ObjectBackend,
    load_keypair,
    transport_from_env,
)
from test_storage import _LoopbackStore, _write_keypair


def _grid(rng, shape=(4, 4, 1, 1)):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_local_backend_layout(tmp_path, rng):
    be = LocalNpyBackend(str(tmp_path))
    arr = _grid(rng)
    base = be.submit_grid("simA", "psi", 7, arr)
    be.close()
    assert base.endswith(os.path.join("simA", "psi_00007"))
    np.testing.assert_array_equal(load_complex_pair(base), arr)


def test_object_backend_rotation(tmp_path, rng):
    be = ObjectBackend(str(tmp_path), accounts=("acc0", "acc1", "acc2"))
    # round-robin by stream seed (reference io.rs:383-401)
    assert [be.account_for(s) for s in (0, 4, None)] == ["acc0", "acc1", "acc0"]
    arr = _grid(rng)
    base = be.submit_grid("simB", "psi", 3, arr, seed=5)
    be.close()
    # flat key in the account namespace: {sim}_{field}_{dump:05}
    assert base.endswith(os.path.join("acc2", "simB_psi_00003"))
    assert be.grid_path("simB", "psi", 3, seed=5) == base
    np.testing.assert_array_equal(load_complex_pair(base), arr)
    np.testing.assert_array_equal(be.load_grid("simB", "psi", 3, seed=5), arr)


def _tree(root) -> dict:
    """Every file under root: relative path -> bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("cdtype", [np.complex64, np.complex128])
def test_same_keys_and_bytes_as_jax(tmp_path, rng, cdtype):
    """For the same grids, seeds and accounts, the port's ObjectBackend
    (directory transport) and LocalNpyBackend write the files JAX's write:
    the same names and the same bytes."""
    grids = [(name, field, dump, seed, _grid(rng).astype(cdtype))
             for name, field, dump, seed in (("s-stream00001", "psi", 0, 1),
                                             ("s-stream00002", "psi", 3, 2),
                                             ("s", "potential", 1, None))]
    urls = {}
    for mod, sub in ((jstorage, "jax"), (tstorage, "port")):
        root = str(tmp_path / sub)
        obj = mod.ObjectBackend(os.path.join(root, "obj"), accounts=("streams-a", "streams-b"))
        local = mod.LocalNpyBackend(os.path.join(root, "local"))
        urls[sub] = [os.path.relpath(u, root) for n, f, d, s, a in grids
                     for u in (obj.submit_grid(n, f, d, a, seed=s), local.submit_grid(n, f, d, a))]
        obj.close()
        local.close()
    assert urls["port"] == urls["jax"]
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(port_tree) == sorted(jax_tree)
    assert len(port_tree) == 2 * 2 * len(grids)
    for k, v in jax_tree.items():
        assert port_tree[k] == v, k


def test_http_same_objects_as_jax(rng):
    """Over HTTP the two packages PUT the same object paths with the same
    bodies."""
    stores = {}
    arr = _grid(rng)
    try:
        for mod, key in ((jstorage, "jax"), (tstorage, "port")):
            store = stores[key] = _LoopbackStore()
            be = mod.ObjectBackend("unused", accounts=("acc0", "acc1"),
                                   transport=mod.HttpTransport(store.url, retries=1))
            be.submit_grid("simH", "psi", 4, arr, seed=7)
            be.close()
        assert stores["port"].objects == stores["jax"].objects
        assert sorted(stores["port"].objects) == ["/acc1/simH_psi_00004_imag",
                                                 "/acc1/simH_psi_00004_real"]
    finally:
        for store in stores.values():
            store.close()


def test_http_transport_roundtrip(rng):
    """A dump round-trips through a real HTTP PUT (reference upload
    semantics: io.rs:410-465 - overwrite, async, URL returned)."""
    store = _LoopbackStore()
    try:
        be = ObjectBackend("unused-root", accounts=("acc0", "acc1"),
                           transport=HttpTransport(store.url, retries=2, backoff_s=0.01))
        arr = _grid(rng)
        url = be.submit_grid("simC", "psi", 2, arr, seed=3)
        be.close()
        assert url == f"{store.url}/acc1/simC_psi_00002"
        got = store.read_array("/acc1/simC_psi_00002_real") + 1j * store.read_array(
            "/acc1/simC_psi_00002_imag")
        np.testing.assert_array_equal(got, arr)
        # overwrite: a second upload to the same key replaces the object
        be2 = ObjectBackend("unused-root", accounts=("acc0", "acc1"),
                            transport=HttpTransport(store.url, retries=2, backoff_s=0.01))
        be2.submit_grid("simC", "psi", 2, arr * 2, seed=3)
        be2.close()
        np.testing.assert_array_equal(store.read_array("/acc1/simC_psi_00002_real"),
                                      (arr * 2).real)
    finally:
        store.close()


def test_http_transport_retries(rng):
    store = _LoopbackStore(fail_first=1)
    try:
        be = ObjectBackend("unused-root",
                           transport=HttpTransport(store.url, retries=3, backoff_s=0.01))
        arr = _grid(rng, (2, 2, 1, 1))
        be.submit_grid("simR", "psi", 0, arr)
        be.close()  # raises if the retry did not recover
        assert store.put_count >= 3  # 1 failed + 2 planes
        np.testing.assert_array_equal(store.read_array("/account0/simR_psi_00000_real"),
                                      arr.real)
    finally:
        store.close()


def test_http_transport_gives_up():
    store = _LoopbackStore(fail_first=100)
    try:
        be = ObjectBackend("unused-root",
                           transport=HttpTransport(store.url, retries=2, backoff_s=0.01))
        be.submit_grid("simF", "psi", 0, np.zeros((2, 2, 1, 1)) + 0j)
        with pytest.raises(OSError):
            be.close()
        assert store.put_count == 2
    finally:
        store.close()


def test_http_4xx_fails_fast():
    """A 4xx answer is not retried: one attempt, no backoff."""
    store = _LoopbackStore()
    try:
        tr = HttpTransport(store.url, retries=3, backoff_s=0.05)
        with pytest.raises(OSError):
            tr.get_pair("acct", "nope_00000")
        assert store.get_count == 1
    finally:
        store.close()


def test_keypair_loading_and_errors(tmp_path):
    path = _write_keypair(tmp_path)
    pub, secret = load_keypair(path)
    assert (pub, secret) == jstorage.load_keypair(path)
    assert pub == bytes(range(32, 64)).hex()
    assert secret == bytes(range(32))
    # 128 hex characters and 64 raw bytes are accepted too
    (tmp_path / "hex").write_text(bytes(range(64)).hex())
    (tmp_path / "raw").write_bytes(bytes(range(64)))
    for f in ("hex", "raw"):
        assert load_keypair(str(tmp_path / f)) == (pub, secret)
    with pytest.raises(KeypairError):
        load_keypair(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2, 3]")
    with pytest.raises(KeypairError):
        load_keypair(str(bad))
    # out-of-range bytes are rejected, not masked into corrupt key material
    oor = tmp_path / "oor.json"
    oor.write_text(str([256] + list(range(63))))
    with pytest.raises(KeypairError):
        load_keypair(str(oor))


def test_http_auth_handshake_and_readback(tmp_path, rng, monkeypatch):
    """On a store that requires the keypair's signature: an unsigned client
    is refused; `from_config` signs its requests, lists the drive's
    accounts and keeps those that contain the configured name (io.rs:
    383-401); a grid reads back by GET through the port's writer."""
    kp = _write_keypair(tmp_path)
    store = _LoopbackStore(accounts=["streams-a", "streams-b", "other"], require_keypair=kp)
    try:
        with pytest.raises(OSError):
            HttpTransport(store.url, retries=1, backoff_s=0.01).put_pair(
                "streams-a", "k", np.zeros((2, 2)) + 0j)
        assert store.auth_failures >= 1
        monkeypatch.setenv("MSM_STORAGE_URL", store.url)
        assert isinstance(transport_from_env(str(tmp_path)), HttpTransport)
        with AsyncGridWriter() as writer:
            be = ObjectBackend.from_config(
                cfg.RemoteStorageConfig(keypair=kp, storage_account="streams"),
                str(tmp_path), writer=writer)
            assert be.accounts == ["streams-a", "streams-b"]
            arr = _grid(rng, (3, 3, 1, 1))
            be.submit_grid("simK", "psi", 1, arr, seed=2)
            np.testing.assert_array_equal(be.load_grid("simK", "psi", 1, seed=2), arr)
            be.close()  # the caller's writer: closed by its owner
        monkeypatch.delenv("MSM_STORAGE_URL")
        assert isinstance(transport_from_env(str(tmp_path)), DirectoryTransport)
    finally:
        store.close()


def test_directory_handshake_falls_back_to_the_name(tmp_path):
    """The directory stand-in lists its account directories; without a
    match the configured name is the one account."""
    conf = cfg.RemoteStorageConfig(keypair="", storage_account="streams")
    assert ObjectBackend.from_config(conf, str(tmp_path / "none")).accounts == ["streams"]
    for acc in ("streams-b", "streams-a", "other"):
        (tmp_path / "drive" / acc).mkdir(parents=True)
    be = ObjectBackend.from_config(conf, str(tmp_path / "drive"))
    assert be.accounts == ["streams-a", "streams-b"]
    assert be.accounts == jstorage.ObjectBackend.from_config(conf, str(tmp_path / "drive")).accounts
