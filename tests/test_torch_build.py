"""CPU tests of the port's kernel build and of what its kernels may call.

* ``_build.target_of`` names a library by a hash of everything the source
  compiles from: an edit to a header under the shared include directory
  (``kernels/include/``, on nvcc's ``-I`` path) must change the target, or a
  stale library would be reused.
* No module of the port calls a library's attention kernel or a compiler of
  plain PyTorch (``scaled_dot_product_attention``, ``torch.compile``,
  ``flash_attn``, ``xformers``), and no CUDA source includes a cuDNN or
  cuBLAS header: every kernel of the port is written by hand.
  ``chip_smoke.py`` and ``attention_timing.py`` time SDPA beside the kernels
  as a yardstick only, and are not part of the package.
"""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import _build

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture
def include_dir(tmp_path, monkeypatch):
    inc = tmp_path / "include"
    (inc / "sub").mkdir(parents=True)
    (inc / "tile.cuh").write_text("#pragma once\nconstexpr int kKeys = 64;\n")
    (inc / "sub" / "more.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "INCLUDE_DIR", inc)
    return inc


@pytest.fixture
def source(tmp_path):
    src = tmp_path / "csrc" / "kern.cu"
    src.parent.mkdir()
    src.write_text('#include "tile.cuh"\nextern "C" int f() { return kKeys; }\n')
    return src


@pytest.mark.parametrize("edit", ["tile.cuh", "sub/more.cuh", "new.cuh"])
def test_target_changes_with_a_shared_header(include_dir, source, edit):
    before = _build.target_of(source)
    assert before == _build.target_of(source)            # deterministic
    header = include_dir / edit
    header.write_text((header.read_text() if header.exists() else "") + "// edited\n")
    assert _build.target_of(source) != before


def test_target_changes_with_the_source_and_a_local_header(include_dir, source):
    before = _build.target_of(source)
    source.write_text(source.read_text() + "// edited\n")
    after_source = _build.target_of(source)
    assert after_source != before
    (source.parent / "local.cuh").write_text("#pragma once\n")
    assert _build.target_of(source) != after_source


def test_the_include_directory_is_on_the_nvcc_path():
    flags = list(_build.NVCC_FLAGS)
    assert flags[flags.index("-I") + 1] == str(_build.INCLUDE_DIR)
    assert (_build.INCLUDE_DIR / "attention_mma.cuh").is_file()
    for cu in ("flash_attention/csrc/flash_attention.cu",
               "decode_attention/csrc/decode_attention.cu"):
        assert '#include "attention_mma.cuh"' in (PORT / "kernels" / cu).read_text()


FORBIDDEN_PY = ("scaled_dot_product_attention", "torch.compile", "flash_attn", "xformers")


@pytest.mark.parametrize("name", FORBIDDEN_PY)
def test_no_port_module_names_a_library_kernel(name):
    hits = [f"{p.relative_to(PORT)}:{i}" for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1) if name in line]
    assert not hits, f"{name} named in {hits}"


def test_no_cuda_source_includes_cudnn_or_cublas():
    sources = sorted(PORT.rglob("*.cu")) + sorted(PORT.rglob("*.cuh"))
    assert len(sources) >= 6
    include = re.compile(r'#\s*include\s*[<"]([^>"]+)[>"]')
    hits = [f"{p.relative_to(PORT)}: {inc}" for p in sources
            for inc in include.findall(p.read_text())
            if re.search(r"cudnn|cublas", inc, re.IGNORECASE)]
    assert not hits, hits
