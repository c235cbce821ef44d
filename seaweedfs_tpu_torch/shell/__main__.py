"""python3 -m seaweedfs_tpu_torch.shell -master HOST:PORT [-c "cmd; cmd"]

Runs the ';'-separated commands of ``-c`` (an 'exit' ends them), or reads
commands from standard input until 'exit' or its end."""

from __future__ import annotations

import argparse
import sys

from . import CommandEnv, run_command, split_script


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m seaweedfs_tpu_torch.shell",
                                 description="The cluster's admin shell.")
    ap.add_argument("-master", default="127.0.0.1:9333")
    ap.add_argument("-c", default="", help="commands to run, then exit")
    args = ap.parse_args(argv)
    env = CommandEnv(args.master)
    if args.c:
        for line in split_script(args.c):
            if not run_command(env, line):
                break
        return 0
    print("seaweedfs_tpu_torch shell; 'help' lists commands, 'exit' quits")
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            break
        if not run_command(env, line):
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
