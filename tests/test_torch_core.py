"""Scheme math parity: the port's numpy copy of ``repro.core`` gives
bitwise the reference's supports, encoding matrices and system matrices
for every registered scheme, and the same recoverability verdict for
every straggler pattern."""

import dataclasses
import itertools

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import repro.api as ref_api
import repro.core as ref_core
import repro.core.decoding as ref_dec
import repro_torch.api as port_api
import repro_torch.core as port_core
import repro_torch.core.decoding as port_dec

ALL = [(i.kind, i.name) for i in ref_api.list_schemes()]


def scheme_kwargs(kind, name):
    info = ref_api.scheme_info(name, kind)
    if info.hetero:
        return {"capacities": [2, 1, 1, 1], "k_A": 3}
    if kind == "mm":
        return {"n": 10, "k_A": 2, "k_B": 4, "kind": "mm"}
    return {"n": 9, "k_A": 6}


def both(kind, name):
    kw = scheme_kwargs(kind, name)
    return ref_api.make_scheme(name, **kw), port_api.make_scheme(name, **kw)


def test_registry_has_the_same_fourteen_schemes():
    ref = [(i.kind, i.name, i.as_dict()) for i in ref_api.list_schemes()]
    port = [(i.kind, i.name, i.as_dict()) for i in port_api.list_schemes()]
    assert len(ref) == 14
    assert port == ref
    assert (port_api.scheme_names("mv", resilient_only=True)
            == ref_api.scheme_names("mv", resilient_only=True))


@pytest.mark.parametrize("kind,name", ALL)
@pytest.mark.parametrize("seed", [0, 7])
def test_scheme_matrices_bitwise(kind, name, seed):
    ref, port = both(kind, name)
    assert type(port).__name__ == type(ref).__name__
    if kind == "mv":
        assert port.supports == ref.supports
        assert (port.omega_A, port.k_A, port.s, port.tasks_per_worker) == (
            ref.omega_A, ref.k_A, ref.s, ref.tasks_per_worker)
        np.testing.assert_array_equal(
            port_core.mv_encoding_matrix(port, seed),
            ref_core.mv_encoding_matrix(ref, seed))
    else:
        assert (port.supports_A, port.supports_B) == (ref.supports_A,
                                                      ref.supports_B)
        assert (port.omega_A, port.omega_B) == (ref.omega_A, ref.omega_B)
        for a, b in zip(port_core.mm_encoding_matrices(port, seed),
                        ref_core.mm_encoding_matrices(ref, seed)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_core.system_matrix(port, seed),
                                  ref_core.system_matrix(ref, seed))
    assert port.weight() == ref.weight()


@pytest.mark.parametrize("kind,name", ALL)
def test_recoverability_over_every_pattern(kind, name):
    ref, port = both(kind, name)
    G_ref = ref_core.system_matrix(ref, 3)
    G_port = port_core.system_matrix(port, 3)
    for pat in itertools.combinations(range(ref.n), ref.s):
        rows = ref_dec._fastest_k_rows(ref, pat)
        assert port_dec._fastest_k_rows(port, pat) == rows
        assert (port_core.is_recoverable(G_port, rows)
                == ref_core.is_recoverable(G_ref, rows))
    assert (port_core.verify_full_recovery(port, seed=3)
            == ref_core.verify_full_recovery(ref, seed=3))


@pytest.mark.parametrize("n", range(2, 13))
def test_weight_laws(n):
    for s in range(n):
        assert port_core.min_weight(n, s) == ref_core.min_weight(n, s)
        assert port_core.weight_regime(n, s) == ref_core.weight_regime(n, s)
    for k_a in range(1, n + 1):
        assert port_core.mv_weight(n, k_a) == ref_core.mv_weight(n, k_a)
        assert (port_core.cyclic31_mv_weight(n, k_a)
                == ref_core.cyclic31_mv_weight(n, k_a))
    for k_a in range(1, n + 1):
        for k_b in range(k_a, n + 1):
            k = k_a * k_b
            if k > n or n - k > k:
                continue
            assert (dataclasses.astuple(port_core.choose_mm_weights(n, k_a, k_b))
                    == dataclasses.astuple(ref_core.choose_mm_weights(n, k_a, k_b)))


def test_decode_and_stability_reports_match():
    ref, port = both("mv", "proposed")
    G = ref_core.system_matrix(ref, 1)
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((ref.n, 5))
    rows = [0, 2, 3, 5, 6, 8]
    np.testing.assert_array_equal(port_core.decode(G, rows, Y),
                                  ref_core.decode(G, rows, Y))
    assert (dataclasses.astuple(port_core.stability_report(port, seed=1))
            == dataclasses.astuple(ref_core.stability_report(ref, seed=1)))
    np.testing.assert_array_equal(
        port_core.khatri_rao_rows(G[:, :2], G[:, 2:]),
        ref_core.khatri_rao_rows(G[:, :2], G[:, 2:]))


@pytest.mark.parametrize("name,kw,trials", [
    ("proposed", {"n": 6, "s": 2}, 8),
    ("cyclic31", {"n": 9, "k_A": 6}, 3),
    ("poly", {"n": 6, "s": 2}, 5),
    ("proposed", {"n": 10, "k_A": 2, "k_B": 4, "kind": "mm"}, 2),
])
def test_find_good_coefficients_bitwise(name, kw, trials):
    port = port_core.find_good_coefficients(
        port_api.make_scheme(name, **kw), trials=trials, max_patterns=64)
    ref = ref_core.find_good_coefficients(
        ref_api.make_scheme(name, **kw), trials=trials, max_patterns=64)
    assert port.best_seed == ref.best_seed
    assert port.best_kappa_worst == ref.best_kappa_worst
    assert port.per_trial_kappas == ref.per_trial_kappas
    assert (dataclasses.astuple(port.report)
            == dataclasses.astuple(ref.report))
    assert port.wall_time_s >= 0.0


def test_straggler_models_bitwise():
    work = np.array([3.0, 1.0, 2.5, 0.5, 4.0, 1.5])
    for port_model, ref_model in (
            (port_core.ShiftedExponential(), ref_core.ShiftedExponential()),
            (port_core.ShiftedExponential(shift=0.5, rate=4.0),
             ref_core.ShiftedExponential(shift=0.5, rate=4.0)),
            (port_core.AdversarialSlow((1, 4), 7.0),
             ref_core.AdversarialSlow((1, 4), 7.0))):
        rp, rr = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(3):
            tp, tr = port_model.sample(work, rp), ref_model.sample(work, rr)
            np.testing.assert_array_equal(tp, tr)
            np.testing.assert_array_equal(port_core.completion_order(tp),
                                          ref_core.completion_order(tr))
            assert port_core.fastest_k(tp, 4) == ref_core.fastest_k(tr, 4)
            assert port_core.job_time(tp, 4) == ref_core.job_time(tr, 4)
        assert (port_core.simulate_job(work, 4, port_model,
                                       np.random.default_rng(1), n_rounds=50)
                == ref_core.simulate_job(work, 4, ref_model,
                                         np.random.default_rng(1),
                                         n_rounds=50))
    assert (port_core.simulate_job(work, 3, n_rounds=20)
            == ref_core.simulate_job(work, 3, n_rounds=20))


@pytest.mark.parametrize("kind", [None, "mv", "mm"])
def test_list_schemes_table_text_equal(kind, capsys):
    import repro.api.__main__ as ref_cli
    import repro_torch.api.__main__ as port_cli

    assert port_cli.format_scheme_table(kind) == \
        ref_cli.format_scheme_table(kind)
    argv = ["--list-schemes"] + ([] if kind is None else ["--kind", kind])
    assert port_cli.main(argv) == 0
    port_out = capsys.readouterr().out
    assert ref_cli.main(argv) == 0
    assert port_out == capsys.readouterr().out
    assert port_cli.main([]) == 1
