"""shell — the admin shell's commands: EC (``ec.encode``, ``ec.rebuild``,
``ec.decode``, ``ec.balance``, ``volume.ec.scrub``,
``volume.ec.degraded``), volume (``volume.list``, ``volume.copy``,
``volume.move``, ``volume.balance``, ``volume.fix.replication``,
``volume.fsck``, ``volume.vacuum``, ``volume.delete``, ``volume.mount``,
``volume.unmount``, ``volume.configure.replication``), collection
(``collection.list``, ``collection.delete``), cluster
(``cluster.repairs``, ``cluster.devices``), driving a cluster through its
master and its volume servers' admin routes; and, with a filer, fs
(``fs.cd``, ``fs.pwd``, ``fs.ls``, ``fs.cat``, ``fs.du``, ``fs.tree``,
``fs.mkdir``, ``fs.mv``, ``fs.rm``, ``fs.meta.cat``, ``fs.meta.save``,
``fs.meta.load``, ``fs.meta.notify``) and bucket (``bucket.list``,
``bucket.create``, ``bucket.delete``)."""

from . import command_bucket  # noqa: F401  (the bucket.* ones)
from . import command_cluster  # noqa: F401  (registers the cluster.* ones)
from . import command_collection  # noqa: F401  (the collection.* ones)
from . import command_ec  # noqa: F401  (registers the ec.* commands)
from . import command_fs  # noqa: F401  (the fs.* ones)
from . import command_volume  # noqa: F401  (the volume.* ones)
from .command_env import (COMMANDS, CommandEnv, command,  # noqa: F401
                          run_command, split_script)
