"""Algorithm-selection harness (native reimplementation of the reference ai/).

The reference's ai/ directory calls the Go engine through gopy bindings,
serializes per-file per-algorithm benchmark results to data.json, and stops
at an UNTRAINED Keras model (one Dense layer, never fit — ai/helpers/ai.py:6).
Being already in Python, this package talks to the engine directly, and the
model is an actually-trained flax/optax classifier that picks the best
algorithm from cheap file features.
"""

from raisin_jax.ai.features import file_features, entropy_nats, sniff_mime  # noqa: F401
from raisin_jax.ai.harness import benchmark_files, generate_dataset  # noqa: F401
from raisin_jax.ai.model import AlgorithmPicker  # noqa: F401
