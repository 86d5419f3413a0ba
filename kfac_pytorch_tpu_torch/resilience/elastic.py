"""World-size-aware resume (the port of ``elastic_resume`` in
``kfac_pytorch_tpu/resilience/elastic.py``): a run relaunched at another
world, smaller or larger, resumes from checkpoints taken at the old one.

The checkpoints' world is the stamp the previous run left beside them
(``utils.checkpoint.write_world_stamp``, ``world.json``). A checkpoint
taken at world ``P`` holds every rank's K-FAC state in rank order; the
resume restores that list against the old world's structure and carries
it into the new world's row layout through ``KFAC.replan(num_devices=)``,
factors and (same method) decompositions row for row, so the relaunched
run preconditions from its first step. The model, optimizer, step and
health counters are the same on every rank and restore unchanged.

The pod supervisor that decides a shrink or a grow, its heartbeat and
its lineage bookkeeping are not ported (ROADMAP queue 1, slice G); the
lineage fence a trainer enforces is (:data:`ENV_LINEAGE`).
"""

import dataclasses
import logging
import os

#: the supervisor-to-trainer lineage contract: the monotonic lineage
#: epoch of the membership this trainer belongs to. ``world.json`` carries
#: it, and :func:`elastic_resume` refuses checkpoints stamped with a newer
#: lineage than its own (a fenced fork must not resume, or overwrite, the
#: majority's state).
ENV_LINEAGE = 'KFAC_LINEAGE'


def elastic_resume(base_dir, max_epoch, precond, state, *, make_precond,
                   retry=None, on_world_change=None, lineage=None,
                   log=None):
    """``(state, epoch, old_world)``: the newest restorable checkpoint in
    ``base_dir`` at or below ``max_epoch``, laid into ``state`` (a
    ``training.TrainState``; its model is loaded in place).

    With no stamp, no preconditioner, or a stamp equal to
    ``precond.num_devices``: a plain ``auto_resume`` (this rank's entry
    at world>1), ``old_world`` None. With another stamped world:
    ``make_precond(old_world)`` must return a set-up, groupless
    preconditioner of that world over the same layers; the checkpoint is
    restored against its structure, every rank's K-FAC state is carried
    into ``precond``'s layout by ``replan(num_devices=, comm_mode=)`` on
    the host, this rank keeps its entry, and
    ``on_world_change(old_world, new_world)`` fires (the trainers hang
    ``training.world_change_rescale`` there). ``(None, None, old_world)``
    when nothing is restorable.

    ``lineage`` (default the ``KFAC_LINEAGE`` environment; None turns the
    check off): a stamp at a newer lineage raises
    ``utils.checkpoint.StaleLineageError`` before anything is read.
    """
    from kfac_pytorch_tpu_torch.parallel import collectives as coll
    from kfac_pytorch_tpu_torch.utils import checkpoint as ckpt
    lg = log if log is not None else logging.getLogger(__name__)
    if lineage is None:
        raw = os.environ.get(ENV_LINEAGE)
        lineage = int(raw) if raw else None
    stamp = ckpt.read_world_stamp_info(base_dir)
    if (lineage is not None and stamp is not None
            and isinstance(stamp.get('lineage'), int)
            and stamp['lineage'] > lineage):
        raise ckpt.StaleLineageError(
            f'checkpoints in {base_dir} are stamped lineage '
            f'{stamp["lineage"]} but this process is at lineage '
            f'{lineage}: this host belongs to an abandoned (fenced) fork '
            'of the pod; refusing to resume or overwrite the surviving '
            'lineage\'s state')
    old_world = None if stamp is None else stamp['num_devices']
    new_world = getattr(precond, 'num_devices', None)
    group = getattr(precond, 'group', None)
    if (precond is None or old_world is None or new_world is None
            or old_world == new_world):
        restored, epoch = ckpt.auto_resume(base_dir, max_epoch, state,
                                           retry=retry, group=group)
        return restored, epoch, None
    pre_old = make_precond(old_world)
    old_target = dataclasses.replace(
        state, kfac_state=[pre_old.init('cpu')] * old_world)
    restored, epoch = ckpt.auto_resume(base_dir, max_epoch, old_target,
                                       retry=retry)
    if epoch is None:
        return None, None, old_world
    old_states = restored.kfac_state
    carried = pre_old.replan(
        old_states[0] if old_world == 1 else old_states,
        num_devices=new_world, comm_mode=precond.comm_mode)
    if isinstance(carried, list):
        carried = carried[coll.axis_index(group)]
    live = state.kfac_state
    ckpt.check_like(ckpt.kfac_tree(live), ckpt.kfac_tree(carried),
                    'carried kfac_state')
    dev = next(iter(live.factors.values())).device
    carried = ckpt.kfac_state_to(carried, dev)
    # a same-method decomposition is carried row for row; the flag must
    # agree on every rank (a rank may hold only pad rows)
    new_state = dataclasses.replace(
        restored, kfac_state=carried,
        decomposed=bool(restored.decomposed)
        and pre_old.method == precond.method)
    step = int(new_state.step)
    lg.info('elastic resume: transported K-FAC factors AND decompositions '
            'from world %d -> %d at checkpoint-%d (step %d) via replan; '
            'preconditioning resumes immediately', old_world, new_world,
            epoch, step)
    if new_world > old_world:
        lg.info('elastic: grow reshard from_world=%d to_world=%d step=%d',
                old_world, new_world, step)
    if on_world_change is not None:
        on_world_change(old_world, new_world)
    return new_state, epoch, old_world
