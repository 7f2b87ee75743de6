"""host_syncs_per_cycle: the program's ``lss.host_syncs`` counter (the
do-while's reads of its flag) over the window, a dispatch cycle."""


def read(run):
    return run.host_syncs / (run.ticks * run.k)
