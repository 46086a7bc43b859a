"""``Model.loss`` and every parameter's gradient against JAX's for the
fp32 smoke configs of llama-3.2-vision (cross attention, gates at 0.5),
xlstm and zamba2, with remat on equal to remat off bit for bit: the check
and tolerances of ``tests/test_torch_train_loss.py``
(``tests/_torch_train.py``)."""
import pytest

from _torch_train import check_model_loss

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "xlstm-1.3b",
                                  "zamba2-2.7b"])
def test_model_loss_and_grads_match_jax(arch):
    check_model_loss(arch)
