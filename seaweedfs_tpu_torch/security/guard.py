"""The IP whitelist: exact addresses, prefixes that end in a dot
("10.0.") and CIDR networks. An empty list allows every caller. The JAX
package's ``security/guard.py``."""

from __future__ import annotations

import ipaddress
from typing import Iterable, List


class Guard:
    def __init__(self, whitelist: Iterable[str] = ()):
        self.exact: List[str] = []
        self.networks = []
        for item in whitelist:
            item = item.strip()
            if not item:
                continue
            if "/" in item:
                self.networks.append(ipaddress.ip_network(item,
                                                         strict=False))
            else:
                self.exact.append(item)

    @property
    def enabled(self) -> bool:
        return bool(self.exact or self.networks)

    def allows(self, ip: str) -> bool:
        if not self.enabled:
            return True
        if ip in self.exact:
            return True
        for e in self.exact:  # the prefix form "10.0."
            if e.endswith(".") and ip.startswith(e):
                return True
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return False
        return any(addr in net for net in self.networks)
