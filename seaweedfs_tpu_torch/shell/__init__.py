"""shell — the admin shell's commands: EC (``ec.encode``, ``ec.rebuild``,
``ec.decode``, ``ec.balance``, ``volume.ec.scrub``,
``volume.ec.degraded``) and cluster (``cluster.repairs``,
``cluster.devices``), driving a cluster through its master and its volume
servers' admin routes."""

from . import command_cluster  # noqa: F401  (registers the cluster.* ones)
from . import command_ec  # noqa: F401  (registers the ec.* commands)
from .command_env import (COMMANDS, CommandEnv, command,  # noqa: F401
                          run_command, split_script)
