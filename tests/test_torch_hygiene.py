"""The port stands alone: no module of qlora_tpu_torch/, not chip_smoke.py
and not the parallel tests' rank modules (tests/torch_tp_worker.py,
tests/torch_train_worker.py, tests/torch_multihost_worker.py) imports jax, flax or the JAX package
(qlora_tpu); its CUDA
sources include nothing of them, quote no figure measured on a TPU, and each
says which TPU kernel it replaces."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "qlora_tpu")
FILES = sorted((ROOT / "qlora_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_tp_worker.py",
    ROOT / "tests" / "torch_train_worker.py", ROOT / "tests" / "torch_multihost_worker.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_port():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()
    assert ROOT / "qlora_tpu_torch" / "generate" / "serve_int8.py" in FILES
    assert ROOT / "qlora_tpu_torch" / "generate" / "paged.py" in FILES
    assert ROOT / "qlora_tpu_torch" / "utils" / "checkpoint.py" in FILES
    assert ROOT / "qlora_tpu_torch" / "utils" / "hf_import.py" in FILES
    for entry in ("cli.py", "eval/mmlu.py", "serve_openai.py", "generate/search.py",
                  "generate/speculative.py", "eval/judge.py", "eval/baseline.py",
                  "examples/web_demo.py", "scripts/convert_checkpoint.py",
                  "parallel/__init__.py", "parallel/distributed.py", "parallel/megatron_step.py",
                  "parallel/tp_decode.py", "examples/serve_tp.py", "parallel/sharded_step.py",
                  "parallel/tp_step.py", "parallel/sp_step.py", "ops/ring_attention.py",
                  "parallel/mesh.py", "parallel/gspmd_step.py", "dryrun.py"):
        assert ROOT / "qlora_tpu_torch" / entry in FILES


RECIPES = sorted((ROOT / "qlora_tpu_torch" / "scripts").glob("*.sh"))


@pytest.mark.parametrize("path", RECIPES, ids=lambda p: p.name)
def test_recipes_call_the_port_on_one_card(path):
    """A recipe runs the port's modules only (``qlora_tpu_torch.``, never
    ``qlora_tpu.``) and asks for no device mesh, but the long-context
    recipe, whose ring is four sp ranks (as JAX's recipe)."""
    text = path.read_text()
    assert re.findall(r"\bqlora_tpu_torch\.cli\b", text)
    assert not re.findall(r"\bqlora_tpu\.\w+", text)
    meshes = re.findall(r"--mesh_\w+ \d+", text)
    assert meshes == (["--mesh_sp 4"] if path.stem == "finetune_longcontext_sp" else [])


def test_recipe_scan_sees_the_recipes():
    assert len(RECIPES) == 8
    assert not re.findall(r"\bqlora_tpu\.\w+", "python -m qlora_tpu_torch.cli --x 1")
    assert re.findall(r"\bqlora_tpu\.\w+", "python -m qlora_tpu.cli --mesh_sp 4")


# optional packages, imported only inside the function that needs them (the
# card's machine has none of them but scipy)
LAZY = ("transformers", "safetensors", "ml_dtypes", "datasets", "wandb", "openai", "scipy")


def _module_level_imports(path: Path):
    """Imports outside every function body (module level, class bodies,
    module-level conditionals and try blocks)."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.module
            yield from walk(child)

    return list(walk(ast.parse(path.read_text(), filename=str(path))))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_card_path_needs_no_optional_package_at_import(path):
    bad = [m for m in _module_level_imports(path) if m.split(".")[0] in LAZY]
    assert not bad, f"{path.name} imports {bad} at module level"


def test_lazy_import_scan_sees_module_level_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\ntry:\n    import wandb\nexcept ImportError:\n    pass\n"
                   "def f():\n    import transformers\n")
    assert _module_level_imports(src) == ["os", "wandb"]


SOURCES = sorted((ROOT / "qlora_tpu_torch" / "csrc").glob("*.cu*"))
# a TPU generation, its units, or a time in microseconds (the port's own times
# are milliseconds on an H100 and live in PERF.md, not in the sources)
TPU_FIGURE = re.compile(r"v5e|v5p|v4-\d|\bMXU\b|\bVMEM\b|\bVPU\b|µs|\d\s*us\b|HBM SOL", re.I)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_cuda_sources_stand_alone(path):
    text = path.read_text()
    includes = re.findall(r"#\s*include\s*[<\"]([^>\"]+)[>\"]", text)
    assert includes and not [i for i in includes if "jax" in i or "qlora_tpu" in i
                             or "xla" in i.lower() or "torch" in i]
    assert not TPU_FIGURE.findall(text), TPU_FIGURE.findall(text)
    assert "Replaces the TPU kernel" in text          # file and function of the original
    assert 'extern "C"' in text                       # plain C entries, loaded with ctypes


def test_cuda_sources_cover_the_int8_family():
    names = {p.name for p in SOURCES}
    assert {"qmm_i8.cu", "qmm_i8_direct.cu", "qmm_nf4_fwd.cu", "qmm_nf4_bwd.cu",
            "decode_attention.cu", "flash_attention.cu"} <= names
    entries = set()
    for p in SOURCES:
        entries |= set(re.findall(r'extern "C" int (\w+)\(', p.read_text()))
    assert {"qmm_i8_direct", "qmm_nf4_w8a8", "qmm_i8_fwd", "qmm_i8_bwd"} <= entries


def test_cuda_sources_cover_paged_attention():
    path = ROOT / "qlora_tpu_torch" / "csrc" / "paged_attention.cu"
    assert path in SOURCES
    text = path.read_text()
    assert set(re.findall(r'extern "C" int (\w+)\(', text)) == {
        "paged_decode_attention", "paged_chunk_attention"}
    assert "fused_paged_decode_attention" in text and "fused_paged_chunk_attention" in text


def test_cuda_sources_cover_the_w8a8_prefill_and_the_split_chunk():
    """The w8a8 forward's int8 wgmma source and the verify chunk's split-KV
    source are scanned like the rest, each names the TPU function it
    replaces and has the C entry its wrapper calls; the sources they
    replaced stay beside them."""
    csrc = ROOT / "qlora_tpu_torch" / "csrc"
    for name, entry, replaces, before in (
            ("qmm_nf4_w8a8_wgmma.cu", "qmm_nf4_w8a8_wgmma", "_qmm_pallas_w8a8",
             "qmm_i8_direct.cu"),
            ("paged_attention_split.cu", "paged_chunk_attention_split",
             "fused_paged_chunk_attention", "paged_attention.cu")):
        assert csrc / name in SOURCES and csrc / before in SOURCES
        text = (csrc / name).read_text()
        assert set(re.findall(r'extern "C" int (\w+)\(', text)) == {entry}
        assert replaces in text and before in text


def test_cuda_sources_cover_flash_attention():
    """The flash kernels' wgmma source is scanned like the rest, names the TPU
    functions it replaces and has the three C entries the wrappers call; the
    source it replaced stays beside it."""
    path = ROOT / "qlora_tpu_torch" / "csrc" / "flash_attention_wgmma.cu"
    assert path in SOURCES and ROOT / "qlora_tpu_torch" / "csrc" / "flash_attention.cu" in SOURCES
    text = path.read_text()
    assert set(re.findall(r'extern "C" int (\w+)\(', text)) == {
        "flash_wgmma_fwd", "flash_wgmma_bwd_dq", "flash_wgmma_bwd_dkv"}
    assert "::_flash_fwd" in text and "::_flash_bwd" in text


def test_cuda_sources_cover_the_decode_step_kernels():
    """The int8 forward at decode rows and split-KV decode attention have
    sources of their own, scanned like the rest, with the C entries their
    wrappers call and the TPU functions they replace named; the kernels they
    replaced stay beside them as the "before"."""
    csrc = ROOT / "qlora_tpu_torch" / "csrc"
    for name, entries, tpu in (("qmm_i8_decode.cu", {"qmm_i8_decode"}, "::_qmm_pallas_i8"),
                               ("decode_attention_split.cu", {"decode_attention_split"},
                                "::\nfused_decode_attention")):
        path = csrc / name
        assert path in SOURCES
        text = path.read_text()
        assert set(re.findall(r'extern "C" int (\w+)\(', text)) == entries
        assert tpu.replace("\n", "") in text.replace("\n// ", "")
    assert csrc / "qmm_i8.cu" in SOURCES and csrc / "decode_attention.cu" in SOURCES


def test_cuda_sources_cover_the_w8a8_decode_kernel():
    """The direct int8 forward at decode rows has a source of its own,
    scanned like the rest, with the C entry its wrapper calls and the TPU
    function it replaces named; qmm_i8_direct.cu, which it replaced there,
    stays beside it and says it is the "before"; the split paged kernel
    names the decode kernel it took over too."""
    csrc = ROOT / "qlora_tpu_torch" / "csrc"
    path = csrc / "qmm_i8_direct_decode.cu"
    assert path in SOURCES and csrc / "qmm_i8_direct.cu" in SOURCES
    text = path.read_text()
    assert set(re.findall(r'extern "C" int (\w+)\(', text)) == {"qmm_i8_direct_decode"}
    assert "::_qmm_pallas_i8_direct" in text and "qmm_i8_direct.cu" in text
    assert "--use_fast_math" in text and "__fdiv_rn" in text    # the header says which division
    assert "qmm_i8_direct_decode.cu" in (csrc / "qmm_i8_direct.cu").read_text()
    split = (csrc / "paged_attention_split.cu").read_text()
    assert "fused_paged_decode_attention" in split and "C >= 1" in split
    assert "_paged_decode_before" in (csrc / "paged_attention.cu").read_text()


def test_cuda_sources_cover_the_nf4_w8a8_decode_kernel():
    """The w8a8 forward over NF4 at decode rows has a source of its own,
    scanned like the rest, with the C entry its wrapper calls and the TPU
    function it replaces named; qmm_i8_direct.cu, whose NF4 entry it replaced
    there, stays beside it and says it is that kernel's "before", and the
    w8a8 prefill kernel names it for the rows below its own."""
    csrc = ROOT / "qlora_tpu_torch" / "csrc"
    path = csrc / "qmm_nf4_w8a8_decode.cu"
    assert path in SOURCES and csrc / "qmm_i8_direct.cu" in SOURCES
    text = path.read_text()
    assert set(re.findall(r'extern "C" int (\w+)\(', text)) == {"qmm_nf4_w8a8_decode"}
    assert "::_qmm_pallas_w8a8" in text and "qmm_i8_direct.cu" in text
    assert "--use_fast_math" in text and "__fdiv_rn" in text    # the header says which division
    assert "qmm_nf4_w8a8_decode.cu" in (csrc / "qmm_i8_direct.cu").read_text()
    assert "qmm_nf4_w8a8_decode.cu" in (csrc / "qmm_nf4_w8a8_wgmma.cu").read_text()
