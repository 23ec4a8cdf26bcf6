"""chip_smoke.py off the card: it refuses to run without a GPU, and its
phases round-trip through the fused CLI path at a tiny size on the CPU
backend's virtual devices."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# one 1 MB block (the CLI's smallest) and a ragged tail above the device
# minimum of -u960
TINY = dict(block=200_000, tail=60_013)
FLAGS = ["-b1", "-m3", "-f0", "-c16", "-L4", "-u960", "-S8", "-Sa"]


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _result_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def test_chip_smoke_exits_nonzero_without_gpu():
    p = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr
    assert not _result_lines(p.stdout)


def test_chip_smoke_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert p.returncode != 0
    assert not _result_lines(p.stdout)


def test_corpus_is_seeded_and_shaped():
    data, parts = cs.make_corpus(3, **TINY)
    again, _ = cs.make_corpus(3, **TINY)
    assert data == again and data != cs.make_corpus(4, **TINY)[0]
    assert list(parts) == ["text", "records", "dedupe", "zeros", "random",
                           "tail"]
    assert len(data) == 5 * TINY["block"] + TINY["tail"]
    assert parts["zeros"].count(0) > 0.99 * TINY["block"]


def test_roundtrip_phase_tiny(tmp_path):
    data, _ = cs.make_corpus(1, **TINY)
    out = cs.roundtrip(str(tmp_path), "prod", data, FLAGS)
    assert out["encode_routes"] == {"device": 2}
    assert out["decode_routes"] == {"device": 2}


def test_jam_phase_tiny(tmp_path):
    _, parts = cs.make_corpus(2, **TINY)
    out = cs.jam_default(str(tmp_path), parts["text"][:100_000])
    assert out["encode_routes"] == {"device": 1}
    assert out["decode_routes"] == {"device": 1}


def test_multi_card_phase_tiny(tmp_path):
    data, _ = cs.make_corpus(1, **TINY)
    out = cs.multi_card(str(tmp_path), data, FLAGS)
    assert out["encode_routes"] == {"device": 2}


def test_kernels_phase_tiny():
    """The kernel comparison at a tiny size, the kernels in interpret
    mode: both streams' decode and model pass agree with the XLA forms."""
    _, parts = cs.make_corpus(5, **TINY)
    out = cs.kernels(parts["text"], steps=300, interpret=True)
    assert sorted(out) == ["jam_decode", "jam_model_pass", "prod_decode",
                           "prod_model_pass"]
    assert out["prod_decode"]["chains"] > out["jam_decode"]["chains"] >= 1
    assert out["jam_decode"]["steps"] == 300


def test_check_routes_rejects_host_blocks():
    cs._check_routes({"device": 3, "host:small": 1}, "ok")
    with pytest.raises(AssertionError):
        cs._check_routes({"device": 3, "host:lpx_layout": 1}, "decode")
    with pytest.raises(AssertionError):
        cs._check_routes({}, "empty")
