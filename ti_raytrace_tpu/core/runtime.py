"""Process set-up shared by the entry points (bench.py, the CLI, the
golden gate, chip_smoke.py, scripts): the persistent compile cache and
the device report.

Nothing here rewrites the platform or retries backend start-up: JAX
picks its default backend, and a measuring run that finds no GPU stops.
"""

import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at one directory and return it.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise the cache lives in <checkout>/.cache/jax."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(REPO, ".cache", "jax")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info() -> dict:
    """The first device as JAX reports it, plus the device count."""
    import jax

    devices = jax.devices()
    return dict(platform=devices[0].platform, kind=devices[0].device_kind,
                count=len(devices))


def require_gpu() -> dict:
    """device_info() of a GPU; raises if JAX found none (a measuring run
    never carries on on the CPU)."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default platform is {info['platform']!r}")
    return info


def card_name_and_power() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them.
    Runs in a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
