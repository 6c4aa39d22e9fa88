"""The control comes out not correct: the plain reference computed with
TF32 products, put in the program's place, against the reference in exact
float32, at every published width and the cells' 512 frames but fewer
utterances (so that a test run holds it), on three seeds, by the numbers
that the cells compare (their third step runs inside a graph replay, so
not the change after it).  It needs the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu perfbench/tests
"""

import pytest
import torch

from perfbench import check, corpus, harness

SHORT = {"utterances": 90, "frames": {"kind": "fixed", "frames": 512},
         "source": "a short mix for the test"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tts_acoustic", "vc_rnn"])
def test_the_tf32_control_fails_a_limit(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = harness.load_json(f"{harness.ROOT}/perfbench/configs/"
                               f"{name}.json")
    family, _ = harness.family(config)
    hp = harness.hparams_of(config)
    dev = torch.device("cuda:0")
    for seed in (1, 2, 3):
        sd = harness.seeds(seed)
        raw = corpus.make(config, SHORT, sd["corpus"], dev)
        weights = harness.weights_of(config, sd, dev)
        ref = check.reference_record(family, hp, config["run"], raw, weights,
                                     sd["loop"], dev)
        control = check.reference_record(family, hp, config["run"], raw,
                                         weights, sd["loop"], dev, tf32=True)
        control["change"] = None
        ok, compared = check.verdict(check.readings(control, ref),
                                     config["limits"])
        assert not ok, (seed, compared)

