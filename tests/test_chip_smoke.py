"""chip_smoke.py off the card.

The script's real run needs a GPU.  Here: the CPU rehearsal (same
phases, tiny sizes, cluster kernel interpreted) must pass and end in the
parseable contract line; without --rehearse it must fail on the CPU
without printing that line; and a copy of the script alone, without the
package beside it, must fail too.
"""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # one device, as on a one-card machine
    return env


def _run(args, cwd, timeout):
    return subprocess.run([sys.executable, SCRIPT if cwd == REPO else
                           os.path.join(cwd, "chip_smoke.py"), *args],
                          cwd=cwd, env=_env(), capture_output=True,
                          text=True, timeout=timeout)


def test_rehearsal_passes_with_contract_line():
    out = _run(["--rehearse"], REPO, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    for n in range(1, 6):
        assert f"== phase {n}" in out.stdout


def test_without_rehearse_fails_on_cpu():
    out = _run([], REPO, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run([], str(tmp_path), timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
