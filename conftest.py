"""The stand-in registry of the benchmark's result tests, completed.

`portbench/conftest.py` fills the program's registry as a traced run leaves
it, for `portbench/tests/test_portbench_result.py`, with the step spans and
the gaps between groups. A run of the program also counts its LayerNorm
calls (`n1.launches`, read by `portbench/metrics/n1_share.train.py`), and a
CRIS step times its stages (`cris.visual` and kin, read by
`portbench/metrics/cris_*_ms.train.py`): this adds them, after that fixture
has filled the registry. Every other test is left as it is."""
import pytest

# the LayerNorm calls of one CLIPSeg forward: 21 in the ViT, 25 in the text
# tower, 6 in the decoder
CLIPSEG_LAYER_NORMS = 52
# device ms of a CRIS step's stages, two steps of an unprofiled group
CRIS_STAGES = {"cris.visual": [38.1, 38.0], "cris.text": [1.9, 1.9],
               "cris.neck": [9.4, 9.3], "cris.decoder": [12.2, 12.1],
               "cris.head": [21.5, 21.4]}


@pytest.fixture(autouse=True)
def _program_records(request):
    if request.path.name == "test_portbench_result.py":
        request.getfixturevalue("program_registry")
        from tunevlseg_torch.utils import profiling
        profiling.count("n1.launches", CLIPSEG_LAYER_NORMS)
        profiling.registry().unprofiled["spans"].update(CRIS_STAGES)
    yield
