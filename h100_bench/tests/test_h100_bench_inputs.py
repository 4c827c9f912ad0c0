"""The request pool made from the seed."""
import numpy as np

from h100_bench import inputs


def test_each_call_gets_its_own_inputs_without_a_copy():
    """Call i's mixture is a pool mixture with i·1e-6 on each utterance's
    first sample, written in place: no two calls alike, the same call
    alike each time it is asked for, the rest of the pool untouched."""
    traffic = {"batch": 3, "seconds_of_audio": 0.01, "sample_rate": 16000, "snr_db": [-5, 5],
               "pool": 2, "frame_pool": 2, "frames": 2, "frame_size": 4}
    pool = inputs.Pool(traffic, 2 ** 31 + 3)
    clean = [m.copy() for m in pool.mixes]
    seen = []
    for i in range(6):
        mix, target, frames = pool.call(i)
        assert mix is pool.mixes[i % 2] and frames is pool.frames[i % 2]
        assert np.array_equal(mix[:, 1:], clean[i % 2][:, 1:])
        np.testing.assert_array_equal(mix[:, 0], clean[i % 2][:, 0] + np.float32(i * 1e-6))
        seen.append(mix.copy())
    assert all(not np.array_equal(a, b) for k, a in enumerate(seen) for b in seen[:k])
    again = pool.call(3)[0].copy()
    pool.call(4)
    assert np.array_equal(pool.call(3)[0], again)
