"""The port's batched MuJoCo oracle (`envs/oracle.py`) against the JAX
package's: the same C++ source behind the same ctypes signatures, so from
the same states and controls both give the same qpos and qvel bit for bit.
The port builds its own library from native/mujoco_batch.cpp under
build/native/; the reference's cases (tests/test_oracle.py) are mirrored.
"""

import os

import numpy as np
import pytest

from surreal_tpu_torch.envs import oracle as toracle

mujoco = pytest.importorskip("mujoco")


@pytest.fixture(scope="module")
def lib():
    return toracle.library_path()


def test_library_is_built_from_the_source_beside_the_reference(lib):
    assert lib.parent == toracle.BUILD_DIR and lib.name.startswith("libmjbatch_")
    assert toracle.SOURCE.name == "mujoco_batch.cpp" and toracle.SOURCE.parent.name == "native"
    assert toracle.library_path() == lib  # built once, then found by its hash


def test_create_step_state_roundtrip(lib, rng):
    pytest.importorskip("dm_control")
    o = toracle.BatchedOracle.for_domain("cheetah", 8, n_threads=4)
    assert (o.nq, o.nv, o.nu) == (9, 9, 6)
    q = rng.uniform(-0.1, 0.1, (8, 9))
    v = rng.uniform(-0.1, 0.1, (8, 9))
    o.set_state(q, v)
    qo, vo = o.get_state()
    np.testing.assert_allclose(qo, q)
    np.testing.assert_allclose(vo, v)
    o.step(rng.uniform(-1, 1, (8, 6)), nsteps=5)
    q1, _ = o.get_state()
    assert not np.allclose(q1, q) and np.isfinite(q1).all()
    # envs with identical state and ctrl stay identical across the pool's threads
    o.set_state(np.tile(q[:1], (8, 1)), np.tile(v[:1], (8, 1)))
    o.step(np.tile(rng.uniform(-1, 1, (1, 6)), (8, 1)), nsteps=10)
    q2, _ = o.get_state()
    np.testing.assert_array_equal(q2, np.tile(q2[:1], (8, 1)))
    o.close()


def test_matches_dm_control_env(lib, rng):
    suite = pytest.importorskip("dm_control.suite")
    denv = suite.load("walker", "walk")
    o = toracle.BatchedOracle.for_domain("walker", 2)
    q, v = rng.uniform(-0.2, 0.2, 9), rng.uniform(-0.2, 0.2, 9)
    denv.reset()
    denv.physics.data.qpos[:] = q
    denv.physics.data.qvel[:] = v
    mujoco.mj_forward(denv.physics.model._model, denv.physics.data._data)
    o.set_state(np.tile(q, (2, 1)), np.tile(v, (2, 1)))
    ctrl = rng.uniform(-1, 1, 6)
    for _ in range(20):
        denv.physics.data.ctrl[:] = ctrl
        mujoco.mj_step(denv.physics.model._model, denv.physics.data._data)
    o.step(np.tile(ctrl, (2, 1)), nsteps=20)
    qo, vo = o.get_state()
    np.testing.assert_allclose(qo[0], denv.physics.data.qpos, atol=1e-10)
    np.testing.assert_allclose(vo[0], denv.physics.data.qvel, atol=1e-10)
    o.close()


@pytest.mark.parametrize("domain", ["cheetah", "walker", "finger", "ball_in_cup"])
def test_bitwise_equal_to_reference(lib, domain, rng):
    """The same states and controls through both oracles: qpos, qvel and
    sensordata equal bit for bit after 1 and after 25 steps."""
    pytest.importorskip("dm_control")
    from surreal_tpu.envs import oracle as joracle

    if not os.path.exists(joracle._LIB_PATH):
        pytest.skip("the reference's native library is not built (tools/build_native.py)")
    n = 16
    mine = toracle.BatchedOracle.for_domain(domain, n, n_threads=4)
    ref = joracle.BatchedOracle.for_domain(domain, n, n_threads=3)
    assert (mine.nq, mine.nv, mine.nu, mine.nsensordata) == (
        ref.nq, ref.nv, ref.nu, ref.nsensordata)
    q = rng.uniform(-0.3, 0.3, (n, mine.nq))
    v = rng.uniform(-0.5, 0.5, (n, mine.nv))
    for o in (mine, ref):
        o.set_state(q, v)
    for nsteps in (1, 25):
        ctrl = rng.uniform(-1, 1, (n, mine.nu))
        for o in (mine, ref):
            o.step(ctrl, nsteps=nsteps)
        (qm, vm), (qr, vr) = mine.get_state(), ref.get_state()
        np.testing.assert_array_equal(qm, qr)
        np.testing.assert_array_equal(vm, vr)
        np.testing.assert_array_equal(mine.sensordata(), ref.sensordata())
    assert not np.array_equal(qm, q)
    mine.close()
    ref.close()
