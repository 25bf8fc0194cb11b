import os

import pytest

from raisin_jax.cli import main, parse_algorithms

from fixtures import VERSE


def test_parse_algorithms_groups():
    # parity with cmd/cli.go:203 incl. "[…]" layer groups
    assert parse_algorithms("lzss,arithmetic") == [["lzss"], ["arithmetic"]]
    assert parse_algorithms("lzss,[lzss,arithmetic],gzip") == [
        ["lzss"],
        ["lzss", "arithmetic"],
        ["gzip"],
    ]
    assert parse_algorithms("[a,b],[c,d]") == [["a", "b"], ["c", "d"]]
    assert parse_algorithms("") == []


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def test_compress_decompress_roundtrip(tmp_path, capsys):
    src = _write(tmp_path, "test.txt", VERSE)
    assert main(["raisin", src]) == 0
    rsn = src + ".rsn"
    assert os.path.exists(rsn)
    out = capsys.readouterr().out
    assert "Compression ratio" in out

    os.remove(src)
    # grape defaults to decompress; reference default deletes the input
    assert main(["grape", rsn]) == 0
    assert not os.path.exists(rsn)
    with open(src, "rb") as f:
        assert f.read() == VERSE


def test_compress_with_algorithm_flag(tmp_path):
    src = _write(tmp_path, "a.txt", VERSE)
    assert main(["raisin", "-compress", src, "-algorithm=huffman", f"-out={src}.h"]) == 0
    assert main(["raisin", "-decompress", f"{src}.h", "-algorithm=huffman", f"-out={src}.out", "-no-delete"]) == 0
    with open(f"{src}.out", "rb") as f:
        assert f.read() == VERSE


def test_multi_file_comma_syntax(tmp_path):
    a = _write(tmp_path, "a.txt", b"first file body first file body")
    b = _write(tmp_path, "b.txt", b"second file body second file body")
    assert main(["raisin", f"{a},{b}", "-algorithm=arithmetic"]) == 0
    assert os.path.exists(a + ".rsn") and os.path.exists(b + ".rsn")


def test_missing_file_error():
    assert main(["raisin", "/nonexistent/file.txt"]) == 1


def test_no_file_error():
    assert main(["raisin"]) == 1
    assert main(["raisin", "-benchmark"]) == 1


def test_benchmark_table(tmp_path, capsys):
    src = _write(tmp_path, "bench.txt", VERSE)
    assert main(["raisin", "-benchmark", src, "-algorithm=arithmetic,huffman,[lzss,arithmetic]"]) == 0
    out = capsys.readouterr().out
    assert "COMPRESSION RATIO" in out
    assert "lzss,arithmetic" in out
    assert "true" in out


def test_benchmark_generate_html(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    src = _write(tmp_path, "bench.txt", VERSE)
    assert main(["raisin", "-benchmark", src, "-algorithm=arithmetic", "-generate"]) == 0
    assert os.path.exists(tmp_path / "index.html")
    html = (tmp_path / "index.html").read_text()
    assert "go-pretty-table" in html and "arithmetic" in html


def test_container_flag_roundtrip(tmp_path):
    src = _write(tmp_path, "c.txt", VERSE * 20)
    assert main(["raisin", str(src), "-container", "-blocksize=2048", f"-out={src}.rsnb"]) == 0
    with open(f"{src}.rsnb", "rb") as f:
        assert f.read(4) == b"RSNB"
    # decompress auto-detects the container magic
    assert main(["raisin", "-decompress", f"{src}.rsnb", f"-out={src}.out", "-no-delete"]) == 0
    with open(f"{src}.out", "rb") as f:
        assert f.read() == VERSE * 20


def test_container_devices_mesh_roundtrip(tmp_path):
    """-devices=N shards container blocks over a 'data' mesh (the mesh must
    be reachable from the product surface)."""
    src = _write(tmp_path, "m.txt", VERSE * 40)
    assert main([
        "raisin", str(src), "-container", "-blocksize=2048",
        "-devices=4", f"-out={src}.rsnb",
    ]) == 0
    # the mesh-encoded container must be byte-identical to the meshless one
    assert main([
        "raisin", str(src), "-container", "-blocksize=2048", f"-out={src}.one",
    ]) == 0
    with open(f"{src}.rsnb", "rb") as f:
        mesh_bytes = f.read()
    with open(f"{src}.one", "rb") as f:
        assert f.read() == mesh_bytes
    assert main([
        "raisin", "-decompress", f"{src}.rsnb", "-devices=4",
        f"-out={src}.out", "-no-delete",
    ]) == 0
    with open(f"{src}.out", "rb") as f:
        assert f.read() == VERSE * 40
