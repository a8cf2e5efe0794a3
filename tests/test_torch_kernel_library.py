"""The port's CUDA library (`repro_torch.kernels.library`) on the CPU.

No kernel runs here: the bindings are held to the `extern "C"` functions
of the sources by reading their text, `launch` and `launch_info` run
against a stub library, and the build is held to its refusal without
`nvcc`. The kernels themselves are checked on the card by chip_smoke.py.
"""
import contextlib
import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import library

REPO = Path(__file__).resolve().parents[1]


def _ctype(decl: str, ret: bool = False):
    """The ctypes type of a C parameter (`type name`) or return type."""
    if "*" in decl:
        return ctypes.c_char_p if ret and "char" in decl else ctypes.c_void_p
    words = decl.split()
    return {"int": ctypes.c_int,
            "long long": ctypes.c_longlong}[" ".join(words if ret
                                                     else words[:-1])]


def _extern_c_functions() -> dict:
    """name -> (argtypes, restype) of every function defined under
    `extern "C"` in SOURCES, read from their text."""
    found = {}
    for src in library.SOURCES:
        blocks = re.findall(r'^extern "C" \{\n(.*?)^\}  // extern "C"',
                            src.read_text(), re.S | re.M)
        assert len(blocks) == 1, f"{src.name}: {len(blocks)} extern C blocks"
        for ret, name, params in re.findall(
                r"^([A-Za-z][\w *]*?)\b(\w+)\(([^)]*)\)\s*\{", blocks[0],
                re.M):
            assert name not in found, f"{name} defined twice"
            found[name] = ([_ctype(p) for p in params.split(",")
                            if p.strip()], _ctype(ret, ret=True))
    return found


def test_signatures_match_the_sources():
    """A binding that drifts from its C definition (a name, an argument's
    count or type) fails here, with no card."""
    assert _extern_c_functions() == library.SIGNATURES


def test_build_dir_is_the_checkouts():
    assert library.BUILD_DIR == REPO / "build" / "repro_torch_kernels"


class _StubLib:
    """Stands in for the loaded library: every entry returns `code`."""

    def __init__(self, code: int):
        self.code = code
        self.calls = []

    def embedding_bag_launch(self, *args):
        self.calls.append(args)
        return self.code

    def embedding_bag_last_launch_info(self, out):
        for i in range(len(out)):
            out[i] = 10 + i
        return self.code

    def embedding_bag_error_string(self, err):
        return f"cuda error {err}".encode()


@pytest.fixture
def stub(monkeypatch):
    """A stub library, and torch.cuda's device and stream on the CPU."""
    def use(code):
        lib = _StubLib(code)
        monkeypatch.setattr(library, "_lib", lib)
        return lib
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=4242))
    return use


def test_launch_appends_the_stream_and_raises_on_an_error(stub):
    lib = stub(0)
    assert library.launch("embedding_bag_launch", "cuda:0", 1, 2) is None
    assert lib.calls == [(1, 2, 4242)]
    stub(9)
    with pytest.raises(RuntimeError,
                       match="embedding_bag_launch failed: cuda error 9"):
        library.launch("embedding_bag_launch", "cuda:0", 1, 2)


def test_launch_info_reads_one_int_a_key(stub):
    stub(0)
    assert library.launch_info("embedding_bag_last_launch_info",
                               ("a", "b")) == {"a": 10, "b": 11}
    stub(3)
    with pytest.raises(RuntimeError, match="embedding_bag_last_launch_info "
                                           "failed: cuda error 3"):
        library.launch_info("embedding_bag_last_launch_info", ("a",))


@pytest.mark.parametrize("step", [library.build, library.load],
                         ids=["build", "load"])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, step):
    """No fallback: where nvcc is missing the build raises, and nothing is
    built or loaded."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(library, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(library, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        step()
    assert library._lib is None
    assert not (tmp_path / "kernels").exists()
