"""collection.* shell commands (the JAX package's
``shell/command_collection.py``, reference command_collection_*.go):
``collection.list`` and ``collection.delete``."""

from __future__ import annotations

from typing import List

from .command_env import CommandEnv, command, parse_flags


@command("collection.list", ": list collections")
def collection_list(env: CommandEnv, args: List[str]):
    names = set()
    for replicas in env.all_volumes().values():
        names.add(replicas[0].get("collection", ""))
    for info in env.ec_volumes().values():
        names.add(info.get("collection", ""))
    for name in sorted(names):
        env.write(f"collection {name!r}")


@command("collection.delete",
         "-collection <name> : delete a collection's volumes")
def collection_delete(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    name = flags.get("collection", "")
    if not name:
        env.write("usage: collection.delete -collection <name>")
        return
    out = env.master_post(f"/col/delete?collection={name}")
    env.write(f"deleted volumes: {out.get('deleted', [])}")
