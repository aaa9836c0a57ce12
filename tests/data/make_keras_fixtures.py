"""Write the committed Keras weight files under tests/data/ that the port's
HDF5 codec is held to (tests/test_torch_hdf5.py, chip_smoke.py):

  keras3_small.weights.h5  `Model.save_weights` (Keras 3 layout,
                           layers/<layer>/vars/<idx>)
  keras_legacy_small.h5    `Model.save` in the legacy .h5 format
                           (model_weights/<layer>/<layer>/<var>, with
                           model_config and the other root attributes)
  keras_small_weights.npz  the arrays the Keras model holds, keyed by the
                           variable's path ("dense/kernel", ...)

The model is a small Dense/BatchNormalization/Dropout stack, 16 -> 32 -> 16
-> 4, with seeded weights and BatchNormalization moments that are not the
initial ones. Runs only where Keras is installed:

  python tests/data/make_keras_fixtures.py
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
IN_DIM, HIDDEN, N_CLASSES = 16, (32, 16), 4


def build():
    import keras
    from keras import layers

    inp = keras.Input((IN_DIM,))
    h = inp
    for i, width in enumerate(HIDDEN):
        h = layers.Dense(width, activation="relu",
                         name="dense" if i == 0 else f"dense_{i}")(h)
        h = layers.BatchNormalization(
            name="batch_normalization" if i == 0
            else f"batch_normalization_{i}")(h)
        h = layers.Dropout(0.4, name="dropout" if i == 0
                           else f"dropout_{i}")(h)
    out = layers.Dense(N_CLASSES, activation="softmax",
                       name=f"dense_{len(HIDDEN)}")(h)
    return keras.Model(inp, out)


def main():
    model = build()
    rng = np.random.default_rng(16)
    arrays = {}
    for v in model.weights:
        a = rng.standard_normal(v.shape).astype(np.float32) * 0.3
        if v.path.endswith("moving_variance") or v.path.endswith("gamma"):
            a = np.abs(a) + 0.5
        v.assign(a)
        arrays[v.path] = a
    model.save_weights(os.path.join(HERE, "keras3_small.weights.h5"))
    model.save(os.path.join(HERE, "keras_legacy_small.h5"))
    np.savez(os.path.join(HERE, "keras_small_weights.npz"), **arrays)
    for name in sorted(os.listdir(HERE)):
        print(name, os.path.getsize(os.path.join(HERE, name)))


if __name__ == "__main__":
    main()
