"""chip_smoke.py phases at tiny size on the CPU, the scripts' refusal to
measure anything but a GPU, the package's import surface without pandas,
and where the compilation cache goes."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def world():
    rep = chip_smoke.Report()
    coords, graph, plan = chip_smoke.phase_graph(rep, 0, 2000, n_check=200,
                                                 block=64)
    assert rep.failed == []
    return coords, graph, plan


def test_phase_graph_checks_knn_and_plan(world):
    _, graph, plan = world
    assert plan.n == 2000 and graph.neighbor_idx.shape == (2000, 6)


def test_phase_headline(world):
    _, graph, plan = world
    rep = chip_smoke.Report()
    per_draw = chip_smoke.phase_headline(rep, graph, plan, 0, 256, P=6)
    assert rep.failed == []
    assert set(per_draw) == {"int4", "int8"}


def test_phase_reference(world):
    coords, graph, plan = world
    rep = chip_smoke.Report()
    chip_smoke.phase_reference(rep, coords, graph, plan, 0, 64)
    assert rep.failed == []


def test_phase_local(world):
    _, graph, plan = world
    rep = chip_smoke.Report()
    chip_smoke.phase_local(rep, graph, plan, 0, 32, P=9, n_ref=8)
    assert rep.failed == []


def test_phase_four_cards_on_virtual_devices(world):
    _, graph, plan = world
    assert len(jax.devices()) >= 4
    rep = chip_smoke.Report()
    chip_smoke.phase_four_cards(rep, graph, plan, 0, 256, 64, P=6)
    assert rep.failed == []


def test_phase_public():
    pytest.importorskip("pandas")
    rep = chip_smoke.Report()
    chip_smoke.phase_public(rep, 0, 1500, 8, P=19)
    assert rep.failed == []


def test_report_records_failures(capsys):
    rep = chip_smoke.Report()
    rep.check("within", 1e-6, 1e-5)
    rep.check("beyond", 1e-3, 1e-5)
    rep.require("false", False)
    assert rep.failed == ["beyond", "false"]
    out = capsys.readouterr().out
    assert "max error 1.000e-03 (tolerance 1.0e-05) FAIL" in out


def test_band_dot_lowering_finds_int32_products():
    text = "\n".join([
        "%a = s32[4,8]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}",
        "%b = f32[4,8]{1,0} dot(%p2, %p3)",
        "%c = (s32[4,8]{1,0}, s8[0]{0}) custom-call(%p0, %p1), "
        "custom_call_target=\"__cublas$lt$matmul\"",
        "%d = s32[4]{0} add(%x, %y)",
    ])
    hits = chip_smoke.band_dot_lowering(text)
    assert len(hits) == 2 and "dot(" in hits[0] and "__cublas" in hits[1]


# ---------------------------------------------------------------------------
# Subprocess checks
# ---------------------------------------------------------------------------


def _env(**extra):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"),
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    env.update(extra)
    return env


def _fake_nvidia_smi(tmp_path):
    stub = tmp_path / "bin" / "nvidia-smi"
    stub.parent.mkdir()
    stub.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    stub.chmod(0o755)
    return f"{stub.parent}:{os.environ.get('PATH', '/usr/bin:/bin')}"


def _no_json_result(stdout):
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_chip_smoke_refuses_without_nvidia_smi(tmp_path):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_env(PATH=str(tmp_path)), capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert res.returncode != 0
    assert _no_json_result(res.stdout)


def test_chip_smoke_refuses_cpu_platform(tmp_path):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_env(PATH=_fake_nvidia_smi(tmp_path)), capture_output=True,
        text=True, timeout=300, cwd=REPO)
    assert res.returncode != 0
    assert "not a GPU" in res.stderr
    assert _no_json_result(res.stdout)


def test_chip_smoke_refuses_without_package(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    (lone / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    res = subprocess.run(
        [sys.executable, str(lone / "chip_smoke.py")],
        env=_env(PATH=_fake_nvidia_smi(tmp_path), PYTHONPATH=""),
        capture_output=True, text=True, timeout=300, cwd=str(lone))
    assert res.returncode != 0
    assert _no_json_result(res.stdout)


def test_bench_refuses_cpu_platform():
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=_env(BENCH_CELLS="256"), capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert res.returncode == 2
    assert "not a GPU" in res.stderr
    assert _no_json_result(res.stdout)


def test_device_path_imports_without_pandas_or_h5py():
    code = (
        "import sys\n"
        "for m in ('pandas', 'h5py', 'sklearn', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import spatialcore_tpu.ops, spatialcore_tpu.parallel\n"
        "import bench, chip_smoke\n"
        "import spatialcore_tpu as sct\n"
        "rep = chip_smoke.Report()\n"
        "chip_smoke.phase_graph(rep, 0, 400, n_check=20, block=64)\n"
        "assert rep.failed == [], rep.failed\n"
        "try:\n"
        "    sct.SpatialData\n"
        "except ImportError as e:\n"
        "    assert 'pandas' in str(e)\n"
        "else:\n"
        "    raise AssertionError('SpatialData without pandas')\n"
        "print('ok', sorted(sct.available_modules()))\n")
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ok" in res.stdout and "'ops'" in res.stdout


@pytest.fixture
def gpu_card():
    """Skips unless ``nvidia-smi`` answers: the test then drives the card
    from a child process (this one is pinned to the CPU)."""
    try:
        chip_smoke.card_info()
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no NVIDIA GPU on this machine; chip_smoke.py covers it")


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_card):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=1200,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"


# ---------------------------------------------------------------------------
# Compilation cache location
# ---------------------------------------------------------------------------


def test_cache_dir_env_variable_wins():
    from spatialcore_tpu import _compile_cache_dir

    assert _compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/c"}, None,
                              "/x/spatialcore_tpu/__init__.py") is None


def test_cache_dir_user_config_wins():
    from spatialcore_tpu import _compile_cache_dir

    assert _compile_cache_dir({}, "/mine",
                              "/x/spatialcore_tpu/__init__.py") is None


def test_cache_dir_defaults_to_checkout():
    from spatialcore_tpu import _compile_cache_dir

    got = _compile_cache_dir({}, None, "/x/y/spatialcore_tpu/__init__.py")
    assert got == os.path.join("/x/y", ".cache", "jax")


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_import_sets_the_cache_dir(tmp_path, env_dir):
    extra = {}
    if env_dir:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    res = subprocess.run(
        [sys.executable, "-c",
         "import spatialcore_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=_env(**extra), capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    want = (str(tmp_path / "cc") if env_dir
            else os.path.join(REPO, ".cache", "jax"))
    assert res.stdout.strip().splitlines()[-1] == want
