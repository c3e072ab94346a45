# Copied from msm_tpu/io/storage.py, which is JAX-free; keep the two in step.
"""Pluggable dump-storage backends.

The reference has two compile-time storage paths: local npy dumps and a
decentralized-drive client (`remote-storage` feature,
`simulator/src/utils/io.rs:338-481`) that uploads each grid to a named
storage account — selected round-robin by stream seed (`io.rs:352-408`) —
under flat keys `{sim_name}_psi_{dump:05}` (`simulation_object.rs:1186-1189`).

Here storage is a runtime-pluggable backend:

- `LocalNpyBackend` (default): the reference's local layout,
  `{root}/{sim_name}/psi_{dump:05}_{real,imag}`.
- `ObjectBackend`: the remote-storage shape — flat keys in per-account
  namespaces with seed-based account rotation and async uploads — over a
  pluggable TRANSPORT:

    * `DirectoryTransport` (default): a directory tree standing in for the
      remote service (this environment has no network egress).
    * `HttpTransport`: a real HTTP object-store client — PUT with
      overwrite semantics and bounded retries, returning the object URL
      like the reference's `upload_grid` (`io.rs:410-465`). Selected by
      `MSM_STORAGE_URL=http://host:port[/prefix]`.

Both run uploads through the bounded async pool (AsyncGridWriter).
"""

from __future__ import annotations

import hashlib
import hmac
import io as _io
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional, Protocol, Sequence

import numpy as np

from ..errors import KeypairError
from .npy import AsyncGridWriter, load_complex_pair, write_complex_pair


def load_keypair(path: str) -> tuple[str, bytes]:
    """Load a remote-storage keypair file -> (pubkey_hex, secret_bytes).

    The reference reads a Solana keypair file — a JSON array of 64 bytes,
    secret||public — and fails with KeypairError when unreadable
    (`io.rs:352-408`, `error.rs:4-35`). Accepted here: that JSON format,
    or 64 raw bytes, or 128 hex chars. The public half identifies the
    client; the secret half signs requests (HMAC stand-in for the ed25519
    signature — no crypto dependency in this environment)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise KeypairError(f"cannot read keypair file {path!r}: {e}") from e
    data: bytes | None = None
    text = raw.strip()
    if text.startswith(b"["):
        try:
            ints = [int(b) for b in json.loads(text)]
            if any(not 0 <= b <= 255 for b in ints):
                # reject out-of-range bytes instead of masking them: a
                # silently mangled key fails server-side with opaque auth
                # errors; the reference raises for unusable keypairs
                raise KeypairError(
                    f"keypair file {path!r} has byte values outside 0..255"
                )
            data = bytes(ints)
        except (ValueError, TypeError) as e:
            raise KeypairError(f"malformed JSON keypair {path!r}: {e}") from e
    elif len(text) == 128:
        try:
            data = bytes.fromhex(text.decode())
        except ValueError:
            data = None
    if data is None and len(raw) == 64:
        data = raw
    if data is None or len(data) != 64:
        raise KeypairError(
            f"keypair file {path!r} is not a 64-byte secret||public pair"
        )
    return data[32:].hex(), data[:32]


class StorageBackend(Protocol):
    """Destination for grid dumps."""

    def submit_grid(self, sim_name: str, field: str, dump: int, arr: np.ndarray) -> str:
        """Queue a grid write; returns the destination key/path."""
        ...

    def wait(self) -> None: ...

    def close(self) -> None: ...


class LocalNpyBackend:
    """Reference-compatible local filesystem layout."""

    def __init__(self, data_root: str = "sim-data", writer: Optional[AsyncGridWriter] = None):
        self.data_root = data_root
        self.writer = writer or AsyncGridWriter()
        self._own = writer is None

    def submit_grid(self, sim_name: str, field: str, dump: int, arr: np.ndarray) -> str:
        d = os.path.join(self.data_root, sim_name)
        os.makedirs(d, exist_ok=True)
        base = os.path.join(d, f"{field}_{dump:05d}")
        self.writer.submit(base, arr)
        return base

    def wait(self) -> None:
        self.writer.wait()

    def close(self) -> None:
        if self._own:
            self.writer.close()


def _npy_bytes(arr: np.ndarray) -> bytes:
    """Serialize an array to npy-format bytes (the upload payload; the
    on-disk and over-the-wire formats match, so a downloaded object is a
    valid `psi_*_real`/`_imag` file)."""
    buf = _io.BytesIO()
    np.lib.format.write_array(buf, np.ascontiguousarray(arr), version=(1, 0))
    return buf.getvalue()


class DirectoryTransport:
    """Local-directory stand-in for the object store (default transport).

    Objects land at `{root}/{account}/{key}`; the "URL" is that path.
    """

    def __init__(self, root: str):
        self.root = root

    def put_pair(self, account: str, key: str, arr: np.ndarray) -> str:
        account_dir = os.path.join(self.root, account)
        os.makedirs(account_dir, exist_ok=True)
        base = os.path.join(account_dir, key)
        write_complex_pair(base, arr)
        return base

    def get_pair(self, account: str, key: str) -> np.ndarray:
        return load_complex_pair(self.object_base(account, key))

    def list_accounts(self) -> list[str]:
        """The drive handshake: existing accounts on the stand-in drive."""
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )

    def object_base(self, account: str, key: str) -> str:
        return os.path.join(self.root, account, key)


class HttpTransport:
    """HTTP object-store client: PUT `{base_url}/{account}/{key}_{plane}`.

    Mirrors the reference's upload semantics (`io.rs:410-465`): uploads
    OVERWRITE existing objects (repeated PUT to the same URL), run inside
    async tasks, and yield the object URL for the caller to record. Bounded
    retries with linear backoff; a transport error after the last attempt
    propagates out of the upload task (surfaces at `writer.wait()`, like
    the reference's unwrap on the joined tokio task).

    With a `keypair` (path from `[remote_storage_parameters]`,
    `parameters.rs:57-66`) every request carries a keypair-derived
    `Authorization: MSM1 {pubkey_hex}:{hmac}` header — the public half
    identifies the client and the secret half HMAC-signs `{METHOD} {path}`
    (the environment-appropriate stand-in for the reference's Solana
    ed25519 request signing, `io.rs:352-408`). GET support makes the
    store readable back (the `--resume` path); `list_accounts` performs
    the reference's account-discovery handshake (GET on the drive root,
    `io.rs:383-401`).
    """

    def __init__(
        self,
        base_url: str,
        retries: int = 3,
        backoff_s: float = 0.25,
        timeout_s: float = 60.0,
        keypair: Optional[str] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.timeout_s = float(timeout_s)
        self._auth: Optional[tuple[str, bytes]] = (
            load_keypair(keypair) if keypair else None
        )

    def _headers(self, method: str, url: str) -> dict:
        h = {"Content-Type": "application/octet-stream"}
        if self._auth is not None:
            pub, secret = self._auth
            path = urllib.parse.urlparse(url).path
            sig = hmac.new(
                secret, f"{method} {path}".encode(), hashlib.sha256
            ).hexdigest()
            h["Authorization"] = f"MSM1 {pub}:{sig}"
        return h

    def _request(self, url: str, method: str, data: Optional[bytes] = None) -> bytes:
        last: Exception | None = None
        for attempt in range(self.retries):
            try:
                req = urllib.request.Request(url, data=data, method=method)
                for k, v in self._headers(method, url).items():
                    req.add_header(k, v)
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    if 200 <= resp.status < 300:
                        return resp.read()
                    last = OSError(f"{method} {url} -> HTTP {resp.status}")
            except urllib.error.HTTPError as e:
                # a definitive server answer: 4xx is not transient — e.g.
                # a store without listing support 404s the root handshake
                # on every construction; retrying only adds backoff sleeps
                if 400 <= e.code < 500:
                    raise OSError(f"{method} {url} -> HTTP {e.code}") from e
                last = e
            except (urllib.error.URLError, OSError) as e:
                last = e
            if attempt + 1 < self.retries:
                time.sleep(self.backoff_s * (attempt + 1))
        raise OSError(
            f"{method} failed after {self.retries} attempts: {url}"
        ) from last

    def _put_object(self, url: str, data: bytes) -> None:
        self._request(url, "PUT", data)

    def put_pair(self, account: str, key: str, arr: np.ndarray) -> str:
        base = self.object_base(account, key)
        arr = np.ascontiguousarray(arr)
        self._put_object(base + "_real", _npy_bytes(arr.real))
        self._put_object(base + "_imag", _npy_bytes(arr.imag))
        return base

    def get_pair(self, account: str, key: str) -> np.ndarray:
        """Read back a grid pair (the resume path; npy over the wire is
        the same format as on disk, `_npy_bytes`)."""
        base = self.object_base(account, key)
        re = np.lib.format.read_array(_io.BytesIO(self._request(base + "_real", "GET")))
        im = np.lib.format.read_array(_io.BytesIO(self._request(base + "_imag", "GET")))
        return re + 1j * im

    def list_accounts(self) -> list[str]:
        """Account-discovery handshake: GET the drive root, accepting a
        JSON list or newline-separated names. Returns [] when the store
        does not support listing (the caller then falls back to the
        configured account name)."""
        try:
            body = self._request(self.base_url + "/", "GET")
        except OSError:
            return []
        text = body.decode("utf-8", "replace").strip()
        if not text:
            return []
        try:
            names = json.loads(text)
            if isinstance(names, list):
                return [str(n) for n in names]
        except ValueError:
            pass
        return [ln.strip().strip("/") for ln in text.splitlines() if ln.strip()]

    def object_base(self, account: str, key: str) -> str:
        return f"{self.base_url}/{account}/{key}"


def transport_from_env(root: str, keypair: Optional[str] = None):
    """Pick the transport: `MSM_STORAGE_URL` selects HTTP (with optional
    `MSM_STORAGE_RETRIES` and the config's keypair for request auth), else
    the local directory stand-in."""
    url = os.environ.get("MSM_STORAGE_URL")
    if url:
        return HttpTransport(
            url,
            retries=int(os.environ.get("MSM_STORAGE_RETRIES", "3")),
            keypair=keypair or None,
        )
    return DirectoryTransport(root)


class ObjectBackend:
    """Remote-storage-shaped backend: accounts + flat keys + rotation.

    `accounts` plays the role of the drive's storage accounts; a stream's
    account is `accounts[seed % len(accounts)]` like the reference's
    round-robin selection (`io.rs:383-401`). Uploads are async and
    overwrite existing objects (`io.rs:427-463`); `submit_grid` returns the
    destination URL (recorded in the run manifest by the simulator).
    """

    def __init__(
        self,
        root: str,
        accounts: Sequence[str] = ("account0",),
        writer: Optional[AsyncGridWriter] = None,
        transport=None,
    ):
        self.root = root
        self.accounts = list(accounts)
        self.writer = writer or AsyncGridWriter()
        self._own = writer is None
        self.transport = transport or transport_from_env(root)

    @classmethod
    def from_config(
        cls, config, root: str, writer: Optional[AsyncGridWriter] = None
    ) -> "ObjectBackend":
        """Build a backend from a `[remote_storage_parameters]` table.

        Mirrors `RemoteStorage::new` (`io.rs:352-408`): the client loads
        the configured keypair (requests are then signed — HttpTransport),
        LISTS the drive's storage accounts, keeps those whose identifier
        CONTAINS the configured name, and rotates among them by stream
        seed. When the listing yields no match, a single account named
        `storage_account` is used (created on first upload).
        """
        name = config.storage_account
        keypair = getattr(config, "keypair", "") or None
        transport = transport_from_env(root, keypair=keypair)
        matches = sorted(a for a in transport.list_accounts() if name in a)
        return cls(root, matches or [name], writer=writer, transport=transport)

    def account_for(self, seed: Optional[int]) -> str:
        if seed is None:
            return self.accounts[0]
        return self.accounts[seed % len(self.accounts)]

    def submit_grid(
        self,
        sim_name: str,
        field: str,
        dump: int,
        arr: np.ndarray,
        seed: Optional[int] = None,
    ) -> str:
        # flat key, reference naming: {sim_name}_{field}_{dump:05}
        key = f"{sim_name}_{field}_{dump:05d}"
        account = self.account_for(seed)
        arr = np.ascontiguousarray(arr)
        self.writer.submit_task(lambda: self.transport.put_pair(account, key, arr))
        return self.transport.object_base(account, key)

    def grid_path(
        self, sim_name: str, field: str, dump: int, seed: Optional[int] = None
    ) -> str:
        """Destination base path/URL for a grid."""
        key = f"{sim_name}_{field}_{dump:05d}"
        return self.transport.object_base(self.account_for(seed), key)

    def load_grid(
        self, sim_name: str, field: str, dump: int, seed: Optional[int] = None
    ) -> np.ndarray:
        """Read a grid back from the store (the --resume path; the
        reference never reads back — this build's checkpoints do). Waits
        for in-flight uploads first so a just-submitted grid reads
        consistently."""
        self.wait()
        key = f"{sim_name}_{field}_{dump:05d}"
        return np.asarray(self.transport.get_pair(self.account_for(seed), key))

    def wait(self) -> None:
        self.writer.wait()

    def close(self) -> None:
        if self._own:
            self.writer.close()
