"""The port's block service and blob daemon (storage/block_service.py,
storage/blob_server.py) against the JAX package's, exact.

- the local store's roundtrip (MD5 sidecars, a corrupted file refused,
  removal) and its escape check, in both packages;
- a port `RemoteBlockService` against a JAX `BlobServer`, and a JAX
  client against a port server: the same script of writes, uploads,
  removals and reads leaves the same files and sidecars on the server's
  disk as each package's `LocalBlockService` leaves when it runs the
  script itself, and every read answers the same;
- `block_service_for` picks the same backend in both packages.

Every server binds port 0 on 127.0.0.1 and is shut down by its test.
"""

import os

import pytest

from pegasus_tpu.storage import blob_server as jblob
from pegasus_tpu.storage import block_service as jbs
from pegasus_tpu_torch.storage import blob_server as tblob
from pegasus_tpu_torch.storage import block_service as tbs

PKGS = {"jax": (jbs, jblob), "port": (tbs, tblob)}


def tree(root) -> dict:
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def script(bs, tmp_path) -> list:
    """Writes, an upload, an overwrite, a removal and reads; returns what
    each read answered."""
    got = []
    bs.write_file("p/1/7/a.sst", bytes(range(256)) * 17)
    bs.write_file("p/1/7/meta.json", b'{"decree": 7, "files": ["a.sst"]}')
    bs.write_file("p/1/8/b.sst", b"")
    tmp_path.mkdir(parents=True, exist_ok=True)
    src = tmp_path / "local.bin"
    src.write_bytes(b"\x00\x01\xffpayload")
    bs.upload(str(src), "up/l.bin")
    bs.write_file("p/1/7/meta.json", b'{"decree": 9}')
    bs.write_file("gone/x", b"x")
    bs.remove_path("gone")
    got.append(bs.read_file("p/1/7/meta.json"))
    got.append(bs.read_file("p/1/8/b.sst"))
    got.append(sorted(bs.list_dir("p/1")))
    got.append(bs.list_dir("p/1/7"))
    got.append((bs.exists("up/l.bin"), bs.exists("gone/x"),
                bs.exists("nowhere")))
    dst = tmp_path / "down" / "l.bin"
    bs.download("up/l.bin", str(dst))
    got.append(dst.read_bytes())
    return got


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_local_roundtrip_and_md5(tmp_path, pkg):
    bsmod, _ = PKGS[pkg]
    bs = bsmod.LocalBlockService(str(tmp_path / "bs"))
    bs.write_file("a/b/file.bin", b"hello")
    assert bs.exists("a/b/file.bin")
    assert bs.read_file("a/b/file.bin") == b"hello"
    assert bs.list_dir("a/b") == ["file.bin"]
    with open(bs._abs("a/b/file.bin"), "wb") as f:
        f.write(b"corrupted")
    with pytest.raises(IOError):
        bs.read_file("a/b/file.bin")
    bs.remove_path("a")
    assert not bs.exists("a/b/file.bin")


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("path", ["../outside", "a/../../outside",
                                  "/../../etc/x"])
def test_local_rejects_escape(tmp_path, pkg, path):
    bsmod, _ = PKGS[pkg]
    bs = bsmod.LocalBlockService(str(tmp_path / "bs"))
    with pytest.raises(ValueError):
        bs.write_file(path, b"x")
    assert not os.path.exists(tmp_path / "outside")


def test_local_stores_are_byte_equal(tmp_path):
    """The same script through both packages' LocalBlockService: the same
    files, sidecars and answers."""
    trees, answers = [], []
    for pkg in ("jax", "port"):
        bsmod, _ = PKGS[pkg]
        root = tmp_path / pkg / "root"
        answers.append(script(bsmod.LocalBlockService(str(root)),
                              tmp_path / pkg))
        trees.append(tree(root))
    assert answers[0] == answers[1]
    assert trees[0] == trees[1]
    assert any(p.endswith(".md5") for p in trees[0])


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_remote_client_against_the_other_server(tmp_path, client, server):
    """One package's RemoteBlockService against the other's BlobServer
    leaves on the server's disk what a LocalBlockService leaves running
    the script itself, and answers the same."""
    cbs, _ = PKGS[client]
    sbs, sblob = PKGS[server]
    local_root = tmp_path / "local"
    want = script(sbs.LocalBlockService(str(local_root)), tmp_path / "l")
    srv = sblob.BlobServer(str(tmp_path / "served"), host="127.0.0.1",
                           port=0)
    try:
        assert srv.port != 0
        bs = cbs.block_service_for(f"{srv.url}/bucket")
        assert isinstance(bs, cbs.RemoteBlockService)
        got = script(bs, tmp_path / "r")
        with pytest.raises(FileNotFoundError):
            bs.read_file("gone/x")
        # the bucket is a directory of the server's root
        assert tree(tmp_path / "served" / "bucket") == tree(local_root)
        # a corrupted file on the server's disk is refused by the client
        victim = tmp_path / "served" / "bucket" / "p" / "1" / "7" / "a.sst"
        victim.write_bytes(b"flipped")
        with pytest.raises(IOError):
            bs.read_file("p/1/7/a.sst")
    finally:
        srv.close()
    assert got == want


@pytest.mark.parametrize("root", ["remote://127.0.0.1:9/b", "local",
                                  "remote://h"])
def test_block_service_for_picks_the_same_backend(tmp_path, root):
    if root == "local":
        root = str(tmp_path / "bs")
    j = type(jbs.block_service_for(root)).__name__
    t = type(tbs.block_service_for(root)).__name__
    assert j == t
    if root.startswith("remote://"):
        jr, tr = jbs.block_service_for(root), tbs.block_service_for(root)
        assert (jr.host, jr.port, jr.bucket) == (tr.host, tr.port, tr.bucket)
