"""One train step of the port against the reference's for the hybrid
(zamba2: the Mamba2 SSD and the shared attention block), the xLSTM (the
mLSTM chunk scan and the sLSTM recurrence), the encoder-decoder (whisper:
the bidirectional encoder under remat, the decoder's causal and cross
attention) and the VLM (llava: labels over the patches and the text).
Held as in tests/test_torch_train_step.py, whose ``check_one_step`` runs
them: the loss to 1e-5 relative, gradients, ``m`` and ``v`` to 1e-4 of
each leaf's max, the update where |g| exceeds 1e-3 of the leaf's max |g|.
"""
import pytest

from test_torch_train_step import check_one_step


@pytest.mark.parametrize("family", ["hybrid", "xlstm", "encdec", "vlm"])
@pytest.mark.parametrize("accum", [1, 2])
def test_family_step_matches_reference(family, accum):
    unheld, total = check_one_step(family, accum)
    assert unheld < 0.25 * total  # mostly embedding rows the batch never reads
