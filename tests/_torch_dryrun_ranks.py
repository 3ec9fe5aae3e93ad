"""Rank functions of tests/test_torch_dryrun.py (spawned ranks import
them from here): one training step of a reduced model on a (2, 2) gloo
mesh under ``collectives.record()``, whose events the test holds against
the record-only mesh's step on meta. No JAX is imported here."""
import repro_torch.configs as tc
from repro_torch.core import collectives as coll
from repro_torch.core.transform import get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh


def event_key(ev) -> tuple:
    """What a dry event must share with a real one: kind, axes, group,
    elements, dtype, reduction and whether it was issued in the
    backward."""
    return (ev.kind, tuple(ev.axes), ev.group, ev.elems, ev.dtype, ev.op,
            ev.in_backward)


def record_rank(rank, world, cfg, shape, run_kw, encdec) -> list:
    """This rank's record of one step, as ``event_key`` tuples."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    run = get_runner(cfg, shape, tc.RunConfig(**run_kw), mesh=mesh, seed=0)
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                     is_encdec=encdec)
    with coll.record() as rec:
        run.run(ds.batch(0))
    return [event_key(ev) for ev in rec.events]
