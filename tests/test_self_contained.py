"""Self-containedness: the repo renders with /root/reference removed.

`io/assets.py` resolves assets through a chain ending in the mounted
read-only reference (SURVEY.md §2.1 #31); `tools/vendor_assets.py`
vendors everything into `assets/`.  Without this test a missing vendored
file would hide behind the reference mount indefinitely — these checks
run a SUBPROCESS with TIRAY_NO_REFERENCE=1 (the kill-switch consumed at
io/assets.py) and prove (a) every asset the package ever requests
resolves under <repo>/assets, and (b) an OBJ scene build plus the full
spectral/sky table load work end to end with the reference masked.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every `asset_path(rel)` the package (not tests/tools) can request:
# scenes (examples/scenes.py), spectral tables (spectral/cie.py,
# integrators/pt_spec.py), sky coefficients (sky/hosek.py)
MANIFEST = [
    "model/cornell_box.obj",
    "model/cornell_box.mtl",
    "model/sphere.obj",
    "model/bdpt.obj",
    "model/bdpt.mtl",
    "model/prism1.obj",
    "model/prism1.obj.mtl",
    "model/Teapot.obj",
    "image/env.png",
    "spectrum/ciexyz31_1.csv",
    "spectrum/Illuminantd65.csv",
    "spectrum/white-spec.csv",
    "spectrum/red-spec.csv",
    "spectrum/green-spec.csv",
    "sky/data.csv",
    "sky/data_rad.csv",
    "sky/data_solar.csv",
    "sky/data_dark.csv",
]

_SUBPROC = r"""
import os, sys
assert os.environ["TIRAY_NO_REFERENCE"] == "1"
import jax
jax.config.update("jax_platforms", "cpu")

from ti_raytrace_tpu.io.assets import asset_path

repo_assets = os.path.join({repo!r}, "assets")
manifest = {manifest!r}
for rel in manifest:
    p = asset_path(rel)
    assert os.path.realpath(p).startswith(os.path.realpath(repo_assets)), (
        f"{{rel}} resolved outside vendored assets: {{p}}"
    )

# (b) real loads with the reference masked: OBJ scene build (+ BVH,
# material heuristic, MTL) and the spectral + sky precompute stack
from ti_raytrace_tpu.examples.scenes import EXAMPLES
scene, cfg = EXAMPLES["cornell_box"]()
assert int(scene.n_prims) == 36, int(scene.n_prims)

from ti_raytrace_tpu.integrators.pt_spec import make_spectral_data
sdata = make_spectral_data()  # CIE + D65 + rgb2spec + SPDs + Hosek sky

# spec_table must come from the vendored npz, not be regenerated
from ti_raytrace_tpu.spectral import rgb2spec
assert os.path.exists(rgb2spec._CACHE), rgb2spec._CACHE

print("SELF_CONTAINED_OK")
"""


def test_no_reference_subprocess():
    env = dict(os.environ)
    env["TIRAY_NO_REFERENCE"] = "1"
    env.pop("TIRAY_ASSETS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = _SUBPROC.format(repo=REPO, manifest=MANIFEST)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SELF_CONTAINED_OK" in out.stdout
