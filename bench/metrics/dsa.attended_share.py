"""Positions latent attention attended over the positions its sessions
held, in the window: the program's per-layer host counters of a decode
step's rows (``LatentBlock.attended``, the rows each step gathered, as
its selection's shape gives them, and ``cached``, summed over the latent
layers), read before and after it.  Under DeepSeek Sparse Attention a
step gathers the indexer's top ``index_topk`` of its cached positions;
dense attention reads 100.  None where the program keeps no such
counter."""


def read(run):
    if "dsa" not in run.after or "dsa" not in run.before:
        return None
    cached = run.delta("dsa", "cached")
    if cached <= 0:
        return None
    return 100.0 * run.delta("dsa", "attended") / cached
