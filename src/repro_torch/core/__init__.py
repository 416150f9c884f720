"""Core library: sparsity-preserving straggler-optimal coded matrix computation.

The scheme math (``weights``, ``assignment``, ``encoding``, ``decoding``,
``stability``, ``straggler``) is numpy, a copy of ``repro.core``'s so
that every support, encoding matrix, system matrix, coefficient search
and straggler sample is bitwise the reference's; ``coded_matmul`` runs
the pipeline on tensors.
"""

from .assignment import (  # noqa: F401
    HeteroSystem,
    MMScheme,
    MVScheme,
    alg1_supports,
    alg2_supports,
    appearances,
    class_based_mv,
    cyclic31_mm,
    cyclic31_mv,
    hetero_mv,
    make_hetero_system,
    mm_unknown_supports,
    orthopoly_mm,
    orthopoly_mv,
    poly_mm,
    poly_mv,
    proposed_mm,
    proposed_mv,
    repetition_mv,
    rkrp_mm,
    rkrp_mv,
    scs_mv,
    union_cover_count,
)
from .coded_matmul import (  # noqa: F401
    CodedOperator,
    coded_matmat,
    coded_matvec,
    fastest_k_rows,
    merge_block_columns,
    split_block_columns,
)
from .decoding import (  # noqa: F401
    StabilityReport,
    condition_number,
    decode,
    is_recoverable,
    stability_report,
    system_matrix,
    verify_full_recovery,
    worker_task_ids,
)
from .encoding import (  # noqa: F401
    encode_blocks,
    encoded_nnz,
    khatri_rao_rows,
    mm_encoding_matrices,
    mv_encoding_matrix,
    support_mask,
)
from .stability import CoefficientSearchResult, find_good_coefficients  # noqa: F401
from .straggler import (  # noqa: F401
    AdversarialSlow,
    ShiftedExponential,
    completion_order,
    fastest_k,
    job_time,
    simulate_job,
)
from .weights import (  # noqa: F401
    MMWeights,
    choose_mm_weights,
    cyclic31_mm_weights,
    cyclic31_mv_weight,
    min_weight,
    mv_weight,
    weight_regime,
)
