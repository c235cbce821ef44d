"""CommandEnv — what every shell command gets: the master's address, the
output stream and the admin calls to the master and the volume servers;
the command table (``command`` registers into it), ``split_script``,
``run_command`` and the flag parsers; for the fs.* and bucket.*
commands, the filer (``filer()``, the shell's ``-filer``) and the
working directory (``cwd``, ``resolve``). The JAX package's
``shell/command_env.py``."""

from __future__ import annotations

import shlex
import sys
from typing import Callable, Dict, List

from ..server.http_util import HttpError, get_json, post_json

COMMANDS: Dict[str, Callable] = {}
HELP: Dict[str, str] = {}


def command(name: str, help_text: str = ""):
    def deco(fn):
        COMMANDS[name] = fn
        HELP[name] = help_text or (fn.__doc__ or "").strip()
        return fn
    return deco


class CommandEnv:
    def __init__(self, master_url: str, out=None, filer_url: str = ""):
        self.master_url = master_url
        # the filer of the fs.* and bucket.* commands (the shell's
        # -filer, or master.toml's for the maintenance runner)
        self.filer_url = filer_url
        self.cwd = "/"          # the fs.* commands' working directory
        # an admin call moves whole volumes (encode, copy, rebuild): a
        # short deadline would orphan a still-running server-side step
        self.admin_timeout = 3600.0
        self.out = out or sys.stdout

    def write(self, *args):
        print(*args, file=self.out)

    def filer(self):
        """A ``FilerClient`` of the shell's filer (``-filer``)."""
        if not self.filer_url:
            raise HttpError(400, "no filer configured: start the shell "
                                 "with -filer <host:port>")
        from ..filer.filer_client import FilerClient
        return FilerClient(self.filer_url)

    def resolve(self, path: str) -> str:
        """The absolute path of an fs.* operand, relative to ``cwd``."""
        import posixpath
        if not path:
            return self.cwd
        if not path.startswith("/"):
            path = posixpath.join(self.cwd, path)
        return posixpath.normpath(path)

    # -- the cluster's state -------------------------------------------------
    def master_get(self, path: str) -> dict:
        return get_json(f"http://{self.master_url}{path}")

    def master_post(self, path: str) -> dict:
        return post_json(f"http://{self.master_url}{path}")

    def node_post(self, node: str, path: str, timeout: float = None,
                  body: dict = None) -> dict:
        if timeout is None:
            timeout = self.admin_timeout
        return post_json(f"http://{node}{path}", body, timeout=timeout)

    def node_get(self, node: str, path: str) -> dict:
        return get_json(f"http://{node}{path}")

    def cluster_nodes(self) -> List[dict]:
        return self.master_get("/cluster/status").get("nodes", [])

    def all_volumes(self) -> Dict[str, List[dict]]:
        return self.master_get("/cluster/volumes").get("volumes", {})

    def ec_volumes(self) -> Dict[str, dict]:
        return self.master_get("/cluster/ec_status").get("volumes", {})


def split_script(script: str) -> List[str]:
    """A ';'-separated script as its command lines; a ';' inside single
    or double quotes does not split."""
    parts, cur, quote = [], [], None
    for ch in script:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch == ";":
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def run_command(env: CommandEnv, line: str) -> bool:
    """Run one shell line; False on 'exit'. A failing command prints its
    error and the shell goes on."""
    line = line.strip()
    if not line or line.startswith("#"):
        return True
    if line in ("exit", "quit"):
        return False
    try:
        parts = shlex.split(line)
    except ValueError as e:
        env.write(f"error: {e}")
        return True
    name, args = parts[0], parts[1:]
    if name == "help":
        if args and args[0] in HELP:
            env.write(f"{args[0]}: {HELP[args[0]]}")
        else:
            for cmd in sorted(COMMANDS):
                text = HELP.get(cmd, "")
                env.write(f"  {cmd:28s} "
                          f"{text.splitlines()[0] if text else ''}")
        return True
    fn = COMMANDS.get(name)
    if fn is None:
        env.write(f"unknown command {name!r}; try 'help'")
        return True
    try:
        fn(env, args)
    except HttpError as e:
        env.write(f"error: {e.status} {e.message or e}")
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:  # noqa: BLE001 - the shell outlives a command
        env.write(f"error: {type(e).__name__}: {e}")
    return True


def parse_flags2(args: List[str], bool_flags=()):
    """Flags and positional operands; a known boolean flag never takes
    the operand after it: '-l /dir' with bool_flags={'l'} ->
    ({'l': 'true'}, ['/dir'])."""
    flags: Dict[str, str] = {}
    ops: List[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-"):
            key = a.lstrip("-")
            if "=" in key:
                k, v = key.split("=", 1)
                flags[k] = v
            elif key in bool_flags:
                flags[key] = "true"
            elif i + 1 < len(args) and not args[i + 1].startswith("-"):
                flags[key] = args[i + 1]
                i += 1
            else:
                flags[key] = "true"
        else:
            ops.append(a)
        i += 1
    return flags, ops


def parse_flags(args: List[str]) -> Dict[str, str]:
    """'-volumeId 3 -collection x -force' -> {volumeId: 3, ...}."""
    out: Dict[str, str] = {}
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-"):
            key = a.lstrip("-")
            if "=" in key:
                k, v = key.split("=", 1)
                out[k] = v
            elif i + 1 < len(args) and not args[i + 1].startswith("-"):
                out[key] = args[i + 1]
                i += 1
            else:
                out[key] = "true"
        i += 1
    return out
