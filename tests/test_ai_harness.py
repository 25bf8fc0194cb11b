"""ai/ harness: dataset generation, features, benchmark records, trained picker."""

import json

import pytest

from raisin_jax.ai import (
    AlgorithmPicker,
    benchmark_files,
    entropy_nats,
    file_features,
    generate_dataset,
    sniff_mime,
)


def test_entropy_and_mime():
    assert entropy_nats(b"") == 0.0
    assert abs(entropy_nats(b"aabb") - 0.6931) < 1e-3  # ln 2 nats
    assert sniff_mime(b"plain words here") == "text/plain"
    assert sniff_mime(b"\x89PNG\r\n\x1a\nxxxx") == "image/png"
    assert sniff_mime(b"RSNB\x01...") == "application/x-rsnb"


def test_features_shape():
    f = file_features(b"hello world" * 100)
    assert f.shape == (20,)
    assert file_features(b"").shape == (20,)


def test_harness_and_picker(tmp_path):
    files = generate_dataset(str(tmp_path / "corpus"))
    assert len(files) >= 5
    records = benchmark_files(
        files,
        algorithms=[["flate"], ["huffman"], ["lzss"]],
        out_json=str(tmp_path / "data.json"),
    )
    with open(tmp_path / "data.json") as f:
        loaded = json.load(f)
    assert len(loaded) == len(files)
    assert all("results" in r for r in loaded)
    assert any("best" in r for r in loaded)

    picker = AlgorithmPicker()
    loss = picker.fit(records, epochs=200)
    assert loss < 2.0
    # the trained model must at least fit its own tiny training set well
    assert picker.accuracy(records) >= 0.5
    pred = picker.predict(b"the quick brown fox " * 200)
    assert isinstance(pred, list) and all(isinstance(a, str) for a in pred)


def test_experimental_variants_roundtrip():
    from raisin_jax.formats import arithmetic_experimental as ax

    for data in [b"", b"Hello world!", bytes(range(100)) * 2]:
        assert ax.big_decompress(ax.big_compress(data)) == data
    bot, top = ax.range_of(b"hello")
    assert 0.0 <= bot < top <= 1.0
