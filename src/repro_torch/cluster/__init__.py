"""Bandit k-medoids on the port's correlated-SH engine, the counterpart of
``repro.cluster``, with the medoid server's refiner
(:mod:`repro_torch.cluster.service`)."""
from repro_torch.cluster.kmedoids import (
    KMedoidsResult,
    Refiner,
    assign_to_medoids,
    bandit_kmedoids,
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
from repro_torch.cluster.service import (ClusterService, ClusterStream,
                                         ServiceRefiner, kmedoids_via_service)


__all__ = [
    "ClusterService", "ClusterStream", "KMedoidsResult", "PAMResult",
    "Refiner", "ServiceRefiner", "adjusted_rand_index",
    "assign_to_medoids", "bandit_kmedoids", "clustering_cost",
    "distance_matrix", "kmedoids_via_service", "make_direct_refiner",
    "pam_build", "pam_exact", "pam_pulls", "pam_swap",
]
