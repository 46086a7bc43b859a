"""The port's bandit k-medoids on the kernel backends against
``repro.api.kmedoids`` (Pallas in interpret mode on the JAX side; the
port's wrappers take their plain versions on CPU tensors), at the sizes
the JAX package's own k-medoids tests use, plus one l1 case."""
import jax
import pytest

from _torch_compare import kmedoids_same_as_jax
from repro_torch.cluster import adjusted_rand_index
from repro_torch.data.medoid_datasets import CLUSTER_DATASETS

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("backend,dataset,d", [
    ("pallas_pairwise", "planted", 16),
    ("pallas_fused", "planted", 16),
    ("pallas_fused_topk", "planted", 16),
    ("pallas_fused", "rnaseq_like", 32),
])
def test_kmedoids_matches_jax(backend, dataset, d):
    metric, gen = CLUSTER_DATASETS[dataset]
    x, labels = gen(1, 200, d, 3)
    res = kmedoids_same_as_jax(x, 3, jax.random.key(2), backend=backend,
                               metric=metric)
    assert adjusted_rand_index(res.labels, labels) >= 0.95
