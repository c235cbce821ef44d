"""fs.* shell commands: the JAX package's ``shell/command_fs.py``
(reference weed/shell/command_fs_*.go): browse and change the filer's
namespace, and save, load or re-announce its metadata. They need the
shell's ``-filer``."""

from __future__ import annotations

import json
import time
from typing import List

from ..filer.entry import entry_from_wire, entry_to_wire
from ..server.http_util import HttpError, http_call
from .command_env import CommandEnv, command, parse_flags2


def _list_all(client, path: str):
    """Every entry of a directory, paginating past the server's batch
    limit — a silent cap here would truncate fs.meta.save backups and
    fs.rm -r."""
    start = ""
    while True:
        batch = client.list_entries(path, start_file=start, limit=1000)
        yield from batch
        if len(batch) < 1000:
            return
        start = batch[-1].name


def _walk(client, path: str):
    """Yield entries depth-first under path (path's own entry first if
    it exists and is not the root)."""
    from ..filer.filer import NotFoundError
    if path != "/":
        try:
            e = client.find_entry(path)
        except (HttpError, NotFoundError):
            return
        yield e
        if not e.is_directory:
            return
    for e in _list_all(client, path):
        if e.is_directory:
            yield from _walk(client, e.full_path)
        else:
            yield e


@command("fs.cd", "<dir> : change the fs.* working directory")
def fs_cd(env: CommandEnv, args: List[str]):
    path = env.resolve(args[0] if args else "/")
    if path != "/":
        e = env.filer().find_entry(path)
        if not e.is_directory:
            env.write(f"{path} is not a directory")
            return
    env.cwd = path


@command("fs.pwd", ": print the fs.* working directory")
def fs_pwd(env: CommandEnv, args: List[str]):
    env.write(env.cwd)


@command("fs.ls", "[-l] [path] : list a filer directory")
def fs_ls(env: CommandEnv, args: List[str]):
    flags, ops = parse_flags2(args, bool_flags={"l"})
    long = bool(flags.get("l"))
    path = env.resolve(ops[0] if ops else "")
    entries = list(_list_all(env.filer(), path))
    for e in sorted(entries, key=lambda x: x.full_path):
        name = e.name + ("/" if e.is_directory else "")
        if long:
            mtime = time.strftime("%Y-%m-%d %H:%M",
                                  time.localtime(e.attr.mtime))
            env.write(f"{e.attr.mode:o} {e.size():>12} {mtime} {name}")
        else:
            env.write(name)


@command("fs.cat", "<path> : print file content")
def fs_cat(env: CommandEnv, args: List[str]):
    if not args:
        env.write("usage: fs.cat <path>")
        return
    env.filer()        # same no-filer-configured guard as other fs.*
    import urllib.parse
    path = urllib.parse.quote(env.resolve(args[0]))
    data = http_call("GET", f"http://{env.filer_url}{path}")
    try:
        env.write(data.decode())
    except UnicodeDecodeError:
        env.write(f"<{len(data)} binary bytes>")


@command("fs.du", "[path] : disk usage per directory subtree")
def fs_du(env: CommandEnv, args: List[str]):
    path = env.resolve(args[0] if args else "")
    client = env.filer()
    total_bytes = total_files = 0
    for e in _walk(client, path):
        if not e.is_directory:
            total_bytes += e.size()
            total_files += 1
    env.write(f"{total_bytes} bytes\t{total_files} files\t{path}")


@command("fs.tree", "[path] : recursive listing")
def fs_tree(env: CommandEnv, args: List[str]):
    path = env.resolve(args[0] if args else "")
    client = env.filer()
    root_depth = path.rstrip("/").count("/")
    count = 0
    for e in _walk(client, path):
        depth = e.full_path.count("/") - root_depth
        indent = "  " * max(depth, 0)
        suffix = "/" if e.is_directory else f" ({e.size()})"
        env.write(f"{indent}{e.name}{suffix}")
        count += 1
    env.write(f"{count} entries")


@command("fs.mkdir", "<dir> : create a directory")
def fs_mkdir(env: CommandEnv, args: List[str]):
    if not args:
        env.write("usage: fs.mkdir <dir>")
        return
    env.filer().mkdir(env.resolve(args[0]))


@command("fs.mv", "<src> <dst> : move/rename a file or directory")
def fs_mv(env: CommandEnv, args: List[str]):
    if len(args) != 2:
        env.write("usage: fs.mv <src> <dst>")
        return
    src, dst = env.resolve(args[0]), env.resolve(args[1])
    env.filer().rename_entry(src, dst)
    env.write(f"{src} -> {dst}")


@command("fs.rm", "[-r] <path> : delete a file or directory")
def fs_rm(env: CommandEnv, args: List[str]):
    flags, operands = parse_flags2(args, bool_flags={"r"})
    if not operands:
        env.write("usage: fs.rm [-r] <path>")
        return
    for p in operands:
        env.filer().delete_entry(env.resolve(p),
                                 recursive=bool(flags.get("r")),
                                 ignore_recursive_error=False)


@command("fs.meta.cat", "<path> : print one entry's raw metadata")
def fs_meta_cat(env: CommandEnv, args: List[str]):
    """Reference command_fs_meta_cat.go: the full wire-shape entry
    (attrs, chunks, extended) as indented JSON."""
    from ..filer.filer import NotFoundError
    _flags, operands = parse_flags2(args)
    if not operands:
        env.write("usage: fs.meta.cat <path>")
        return
    path = env.resolve(operands[0])
    try:
        e = env.filer().find_entry(path)
    except (HttpError, NotFoundError):
        env.write(f"{path}: not found")
        return
    env.write(json.dumps(entry_to_wire(e), indent=2, sort_keys=True))


@command("fs.meta.save",
         "[-o out.jsonl] [path] : dump filer metadata to a file")
def fs_meta_save(env: CommandEnv, args: List[str]):
    flags, operands = parse_flags2(args)
    path = env.resolve(operands[0] if operands else "")
    out_path = flags.get("o") or \
        f"{(path.strip('/') or 'root').replace('/', '-')}-" \
        f"{time.strftime('%Y-%m-%d-%H-%M')}.meta.jsonl"
    client = env.filer()
    count = 0
    with open(out_path, "w") as f:
        for e in _walk(client, path):
            f.write(json.dumps(entry_to_wire(e),
                               separators=(",", ":")) + "\n")
            count += 1
    env.write(f"saved {count} entries to {out_path}")


@command("fs.meta.load", "-i <in.jsonl> : recreate filer metadata")
def fs_meta_load(env: CommandEnv, args: List[str]):
    flags, operands = parse_flags2(args)
    in_path = flags.get("i") or (operands[0] if operands else "")
    if not in_path:
        env.write("usage: fs.meta.load -i <in.jsonl>")
        return
    client = env.filer()
    count = 0
    with open(in_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            # directories restore through the same create/update path
            # as files so their saved attrs (mode, mtime, owner)
            # survive the round trip
            entry = entry_from_wire(json.loads(line))
            try:
                client.create_entry(entry)
            except HttpError as e:
                if e.status != 409:
                    raise
                client.update_entry(entry)
            count += 1
    env.write(f"loaded {count} entries")


@command("fs.meta.notify",
         "[path] : re-emit metadata events for every entry (replays the "
         "subtree into the event log for subscribers/replicators)")
def fs_meta_notify(env: CommandEnv, args: List[str]):
    path = env.resolve(args[0] if args else "")
    client = env.filer()
    count = 0
    for e in _walk(client, path):
        client.update_entry(e)     # same-content update -> event
        count += 1
    env.write(f"notified {count} entries")
