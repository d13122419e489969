"""Device milliseconds per traced frame of variable-SH shading
(models/variable_sh.py eval_colors): the program's stage clock (stage
'shade', utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "view", ("shade",))
