"""chip_smoke.py's checks.

On the CPU the checks run at a small scale, as a rehearsal of the path the
card runs (and chip_smoke.main itself must refuse to run). The gpu-marked
tests run the same checks on the card at a larger scale; they skip here.
"""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs
from tpu_snappy import api, framing

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def small():
    return cs.smoke_data(0, 2 * 65536 + 1234, 65536 + 7)


def test_check_api_small(small):
    sizes = cs.check_api(small)
    ours, base = sizes["text"]
    assert ours <= base


def test_check_presets_small(small):
    assert set(cs.check_presets(small["text"])) == {"fast", "turbo", "ultra"}


def test_check_framing_small(small):
    out = cs.check_framing(small)
    assert out["always"]["sidecar_chunks"] >= 2
    assert out["always"]["bytes"] > out["auto"]["bytes"]


def test_check_serving_small(small):
    out = cs.check_serving(small["text"], 0, n_requests=4, lo=70_000,
                           hi=100_000)
    assert out["requests"] == 4


def test_check_four_on_virtual_devices(small):
    out = cs.check_four(small["text"], 0, lo=70_000, hi=100_000)
    assert out["devices"] == [0, 1, 2, 3]


def test_no_host_work_flags_every_counter():
    for bump in (lambda: api.host_decodes.update(fragments=1),
                 lambda: api.host_decodes.update(streams=1),
                 lambda: framing.decode_stats.update(host_chunks=1),
                 lambda: framing.decode_stats.update(sidecar_rejected=1)):
        with pytest.raises(AssertionError, match="host fallbacks"):
            with cs.no_host_work():
                bump()
    with cs.no_host_work():
        framing.decode_stats.update(sidecar=2)


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert "no GPU" in out.err
    assert '"ok"' not in out.out


def test_script_alone_fails(tmp_path):
    # In a directory holding chip_smoke.py and nothing else of the repo,
    # the script fails and prints no result line.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture(scope="module")
def large():
    return cs.smoke_data(0, 16 * cs.MIB, 2 * cs.MIB)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["api", "presets", "framing", "serving"])
def test_phase_on_gpu(gpu, large, phase):
    fn = {"api": lambda: cs.check_api(large),
          "presets": lambda: cs.check_presets(large["text"]),
          "framing": lambda: cs.check_framing(large),
          "serving": lambda: cs.check_serving(large["text"], 0)}[phase]
    json.dumps(fn(), default=str)
