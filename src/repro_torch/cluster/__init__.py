"""Bandit k-medoids on the port's correlated-SH engine, the counterpart of
``repro.cluster``. The service refiner (``kmedoids_via_service``,
``ServiceRefiner``) waits for the medoid server (ROADMAP Queue 1 item 11)."""
from repro_torch.cluster.kmedoids import (
    KMedoidsResult,
    Refiner,
    assign_to_medoids,
    make_direct_refiner,
)
from repro_torch.cluster.metrics import adjusted_rand_index, clustering_cost
from repro_torch.cluster.pam_exact import (
    PAMResult,
    distance_matrix,
    pam_build,
    pam_exact,
    pam_pulls,
    pam_swap,
)


def kmedoids_via_service(*args, **kwargs):
    """Not ported yet: refinement through the medoid server."""
    raise ValueError("kmedoids_via_service is not ported to repro_torch "
                     "yet: see ROADMAP Queue 1 item 11 (live serving)")


__all__ = [
    "KMedoidsResult", "PAMResult", "Refiner", "adjusted_rand_index",
    "assign_to_medoids", "clustering_cost", "distance_matrix",
    "kmedoids_via_service", "make_direct_refiner", "pam_build", "pam_exact",
    "pam_pulls", "pam_swap",
]
