"""The stand-in registry of the benchmark's result tests, completed.

`portbench/conftest.py` fills the program's registry as a traced run leaves
it, for `portbench/tests/test_portbench_result.py`, with the step spans and
the gaps between groups. A run of the program also counts its LayerNorm
calls (`n1.launches`, read by `portbench/metrics/n1_share.train.py`): this
adds them, after that fixture has filled the registry. Every other test is
left as it is."""
import pytest

# the LayerNorm calls of one CLIPSeg forward: 21 in the ViT, 25 in the text
# tower, 6 in the decoder
CLIPSEG_LAYER_NORMS = 52


@pytest.fixture(autouse=True)
def _layer_norms_counted(request):
    if request.path.name == "test_portbench_result.py":
        request.getfixturevalue("program_registry")
        from tunevlseg_torch.utils import profiling
        profiling.count("n1.launches", CLIPSEG_LAYER_NORMS)
    yield
