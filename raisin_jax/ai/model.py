"""Best-algorithm picker: a small flax classifier, actually trained.

The reference stops at an untrained Keras model (Normalization + Dense(16),
never fit — ai/helpers/ai.py:6-24). This is the working version: a two-layer
MLP over the cheap file features, trained with optax on harness records.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

try:  # flax/optax are in the base image; degrade gracefully elsewhere
    import flax.linen as nn
    import optax

    _HAVE_FLAX = True
except Exception:  # pragma: no cover
    _HAVE_FLAX = False


class AlgorithmPicker:
    """Predicts the best codec pipeline from file features."""

    def __init__(self, classes: list[str] | None = None) -> None:
        if not _HAVE_FLAX:
            raise RuntimeError("flax/optax unavailable")
        self.classes = classes or []
        self.params = None
        self._norm = (np.zeros(20, np.float32), np.ones(20, np.float32))

        class MLP(nn.Module):
            n_out: int

            @nn.compact
            def __call__(self, x):
                x = nn.Dense(32)(x)
                x = nn.relu(x)
                x = nn.Dense(16)(x)
                x = nn.relu(x)
                return nn.Dense(self.n_out)(x)

        self._mlp_cls = MLP

    @staticmethod
    def _label(algorithms: list[str]) -> str:
        return ",".join(algorithms)

    def fit(self, records: list[dict], epochs: int = 300, lr: float = 3e-3, seed: int = 0):
        """Train on harness records (see ai.harness.benchmark_files)."""
        feats, labels = [], []
        for rec in records:
            if "best" not in rec:
                continue
            feats.append(rec["features"])
            labels.append(self._label(rec["best"]))
        if not feats:
            raise ValueError("no trainable records (no lossless results)")
        self.classes = sorted(set(labels))
        y = np.array([self.classes.index(l) for l in labels], dtype=np.int32)
        X = np.array(feats, dtype=np.float32)
        mu, sd = X.mean(0), X.std(0) + 1e-6
        self._norm = (mu, sd)
        Xn = (X - mu) / sd

        model = self._mlp_cls(n_out=len(self.classes))
        params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, X.shape[1])))
        tx = optax.adam(lr)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, opt_state, xb, yb):
            def loss_fn(p):
                logits = model.apply(p, xb)
                return optax.softmax_cross_entropy_with_integer_labels(logits, yb).mean()

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        loss = None
        for _ in range(epochs):
            params, opt_state, loss = step(params, opt_state, Xn, y)
        self.params = params
        self._model = model
        return float(loss)

    def predict(self, data: bytes) -> list[str]:
        from raisin_jax.ai.features import file_features

        if self.params is None:
            raise RuntimeError("fit() first")
        mu, sd = self._norm
        x = (file_features(data) - mu) / sd
        logits = self._model.apply(self.params, jnp.asarray(x[None, :]))
        return self.classes[int(jnp.argmax(logits))].split(",")

    def accuracy(self, records: list[dict]) -> float:
        ok = tot = 0
        for rec in records:
            if "best" not in rec:
                continue
            mu, sd = self._norm
            x = (np.array(rec["features"], np.float32) - mu) / sd
            logits = self._model.apply(self.params, jnp.asarray(x[None, :]))
            pred = self.classes[int(jnp.argmax(logits))]
            ok += pred == self._label(rec["best"])
            tot += 1
        return ok / max(tot, 1)

    def save(self, path: str) -> None:
        import pickle

        with open(path, "wb") as f:
            pickle.dump(
                {"classes": self.classes, "norm": self._norm, "params": jax.device_get(self.params)},
                f,
            )
