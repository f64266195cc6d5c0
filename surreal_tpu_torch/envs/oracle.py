"""Host-side oracle bridge: batched real MuJoCo stepping (port of
surreal_tpu/envs/oracle.py).

The Python face of `native/mujoco_batch.cpp`, a C++ thread pool that runs
`mj_step` across a batch of envs, loaded through ctypes. Used by parity
tests, CPU-reference throughput measurements and ground-truth rollouts;
never on the training path.

The library is built from that source at first use into `build/native/`
at the repo root, against the installed mujoco wheel's headers and
`libmujoco.so.*` (linked by explicit path, with an rpath, so nothing needs
to be set at load time). It is named after a hash of the source and the
compile command, so an edit or another mujoco rebuilds it. Concurrent
builds each write a temporary file and rename it into place. The
committed `native/libmjbatch.so` is not used: its rpath names the wheel of
the machine that built it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "mujoco_batch.cpp"
BUILD_DIR = _ROOT / "build" / "native"


def _mujoco_paths() -> tuple[str, str, str]:
    """(package dir, include dir, libmujoco file name) of the installed
    mujoco wheel."""
    import mujoco

    pkg = os.path.dirname(mujoco.__file__)
    libs = sorted(f for f in os.listdir(pkg) if f.startswith("libmujoco.so"))
    if not libs:
        raise FileNotFoundError(f"no libmujoco.so* in {pkg}")
    return pkg, os.path.join(pkg, "include"), libs[-1]


def _compile_command(out: str) -> list[str]:
    pkg, include, libname = _mujoco_paths()
    # The wheel ships libmujoco.so.X.Y.Z without a plain .so symlink: link
    # it by explicit path with -l:.
    return ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-pthread", f"-I{include}",
            str(SOURCE), f"-L{pkg}", f"-l:{libname}", f"-Wl,-rpath,{pkg}", "-o", out]


def library_path() -> Path:
    """The oracle library for this source and this mujoco, built first if
    it is missing."""
    key = SOURCE.read_bytes() + " ".join(_compile_command("")).encode()
    path = BUILD_DIR / f"libmjbatch_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(_compile_command(str(tmp)), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


class BatchedOracle:
    """Batched MuJoCo envs stepped by a native thread pool."""

    def __init__(self, xml_path: str, n_envs: int, n_threads: int = 0):
        lib = ctypes.CDLL(str(library_path()))
        lib.mjb_create.restype = ctypes.c_void_p
        lib.mjb_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.mjb_error.restype = ctypes.c_char_p
        for name in ("mjb_nq", "mjb_nv", "mjb_nu", "mjb_nsensordata"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.mjb_set_state.argtypes = [ctypes.c_void_p, dptr, dptr]
        lib.mjb_step.argtypes = [ctypes.c_void_p, dptr, ctypes.c_int]
        lib.mjb_get_state.argtypes = [ctypes.c_void_p, dptr, dptr]
        lib.mjb_get_sensordata.argtypes = [ctypes.c_void_p, dptr]
        lib.mjb_forward.argtypes = [ctypes.c_void_p]
        lib.mjb_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.mjb_create(xml_path.encode(), n_envs, n_threads)
        if not self._h:
            raise RuntimeError(f"mjb_create failed: {lib.mjb_error().decode()}")
        self.n_envs = n_envs
        self.nq = lib.mjb_nq(self._h)
        self.nv = lib.mjb_nv(self._h)
        self.nu = lib.mjb_nu(self._h)
        self.nsensordata = lib.mjb_nsensordata(self._h)

    @classmethod
    def for_domain(cls, domain: str, n_envs: int, n_threads: int = 0) -> BatchedOracle:
        """Loads a dm_control suite domain's XML, resolved from the installed
        dm_control package (its assets lie beside it)."""
        from dm_control import suite as dm_suite

        xml = os.path.join(os.path.dirname(dm_suite.__file__), f"{domain}.xml")
        return cls(xml, n_envs, n_threads)

    def set_state(self, qpos: np.ndarray, qvel: np.ndarray) -> None:
        qpos = np.ascontiguousarray(qpos, np.float64).reshape(self.n_envs, self.nq)
        qvel = np.ascontiguousarray(qvel, np.float64).reshape(self.n_envs, self.nv)
        self._lib.mjb_set_state(self._h, qpos, qvel)

    def step(self, ctrl: np.ndarray, nsteps: int = 1) -> None:
        ctrl = np.ascontiguousarray(ctrl, np.float64).reshape(self.n_envs, self.nu)
        self._lib.mjb_step(self._h, ctrl, nsteps)

    def get_state(self) -> tuple[np.ndarray, np.ndarray]:
        qpos = np.empty((self.n_envs, self.nq), np.float64)
        qvel = np.empty((self.n_envs, self.nv), np.float64)
        self._lib.mjb_get_state(self._h, qpos, qvel)
        return qpos, qvel

    def sensordata(self) -> np.ndarray:
        out = np.empty((self.n_envs, self.nsensordata), np.float64)
        self._lib.mjb_get_sensordata(self._h, out)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.mjb_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
