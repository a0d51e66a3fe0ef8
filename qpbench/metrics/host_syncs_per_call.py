"""host_syncs_per_call: the program's deliberate host reads of device data
per traced call, each a ``jrlqp.sync.<reason>`` span in the profiler's
trace (the dense preparation's padding, the cold replay's empty test, the
carry init's deactivation rounds). ``host_syncs_per_call.track``, the same
count in a trajectory cell, reads with this file."""

from qpbench import stages

read = stages.host_syncs
