"""bucket.* shell commands: the JAX package's
``shell/command_bucket.py`` (reference weed/shell/command_bucket_*.go).
A bucket is a directory under the filer's buckets folder; these go
through ``FilerClient``'s bucket calls, as the S3 gateway does."""

from __future__ import annotations

from typing import List

from .command_env import CommandEnv, command, parse_flags


@command("bucket.list", ": list buckets")
def bucket_list(env: CommandEnv, args: List[str]):
    entries = env.filer().list_buckets()
    if not entries:
        env.write("no buckets")
        return
    for e in entries:
        env.write(e.name)


@command("bucket.create",
         "-name <bucket> [-collection <c>] : create a bucket")
def bucket_create(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    name = flags.get("name")
    if not name:
        env.write("usage: bucket.create -name <bucket>")
        return
    env.filer().create_bucket(name, collection=flags.get("collection", ""))
    env.write(f"created bucket {name}")


@command("bucket.delete", "-name <bucket> : delete a bucket recursively")
def bucket_delete(env: CommandEnv, args: List[str]):
    flags = parse_flags(args)
    name = flags.get("name")
    if not name:
        env.write("usage: bucket.delete -name <bucket>")
        return
    env.filer().delete_bucket(name)
    env.write(f"deleted bucket {name}")
