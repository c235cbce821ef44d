"""shell — the admin shell's EC commands (``ec.encode``, ``ec.rebuild``,
``ec.decode``, ``ec.balance``), driving a cluster through its master and
its volume servers' admin routes."""

from . import command_ec  # noqa: F401  (registers the ec.* commands)
from .command_env import (COMMANDS, CommandEnv, command,  # noqa: F401
                          run_command, split_script)
