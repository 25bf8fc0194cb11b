from raisin_jax.utils import byte_count_si


def test_byte_count_si():
    # parity with engine/util_test.go expectations
    assert byte_count_si(999) == "999 B"
    assert byte_count_si(1000) == "1.0 kB"
    assert byte_count_si(987_654_321) == "987.7 MB"
    assert byte_count_si(1_000_000) == "1.0 MB"
    assert byte_count_si(0) == "0 B"
