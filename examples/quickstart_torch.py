"""Quickstart on the PyTorch port: the LMB client API in 60 lines.

The port's twin of ``examples/quickstart.py``.  Declares the whole stack
in one SystemSpec (expanders, host, a PCIe SSD and a CXL accelerator),
opens an LMBSystem session, exercises typed MemoryHandle capabilities
(alloc / share / free — device-class-agnostic, no raw mmids), then backs
an SSD's L2P index with a LinkedBuffer and shows tier traffic.  On a
CUDA device the 8 onboard pages live on the card and the LMB tier in
pinned host memory; on the CPU both are host tensors and only the
accounting tells the tiers apart.  The entries are ``torch.uint32``, as
the reference's ``jnp.uint32``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import (DeviceClass, DeviceSpec, ExpanderSpec,
                              LMBSystem, StaleHandle, SystemSpec,
                              TierExecutor)

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
device = parser.parse_args().device

# --- the whole fabric, declaratively: one 8 GiB expander, one host, two
# --- devices; the session owns FM/host/arbiter wiring and frees every
# --- live grant when the with-block ends
spec = SystemSpec(
    expanders=(ExpanderSpec(gib=8),),
    hosts=("host0",),
    devices=(DeviceSpec("ssd0"),                            # PCIe (default)
             DeviceSpec("accel0", DeviceClass.CXL, spid=0x11)))

with LMBSystem(spec) as system:
    # --- capability API: alloc/share/free dispatch on DeviceClass -------
    with system.alloc("ssd0", 64 << 20) as h:   # SSD takes 64 MiB
        print(f"alloc  -> {h}")
        print(f"          pcie bus_addr={h.bus_addr:#x} != hpa={h.hpa:#x}"
              "  (IOVA window)")

        peer = h.share("accel0")                # zero-copy share
        print(f"share  -> accel0 sees hpa={peer.hpa:#x} "
              f"bus_addr={peer.bus_addr:#x} dpid={peer.dpid} (same region)")
    # leaving the with-block freed the grant (and revoked accel0's map)
    print(f"free   -> fm holds {system.fm.held_bytes('host0')} bytes "
          "(block returned)")
    try:
        peer.expander()
    except StaleHandle as e:
        print(f"stale  -> {e}")

    # --- LinkedBuffer: an L2P table bigger than onboard DRAM ------------
    # 64 logical pages of mapping entries; only 8 fit "onboard".
    l2p = system.buffer(name="l2p", device_id="ssd0",
                        executor=TierExecutor(device),
                        page_shape=(1024,), dtype=torch.uint32,
                        onboard_pages=8, policy="clock", prefetch_depth=2)
    pages = l2p.append_pages(64)
    for p in pages:                                # populate the index
        l2p.write(p, np.full((1024,), p, np.uint32))

    rng = np.random.default_rng(0)
    for lba in rng.zipf(1.5, 2000):                # hot/cold lookups
        page = int(lba) % 64
        entry = l2p.read(page)                     # faults cold pages in
        assert int(entry[0]) == page

    print("l2p stats:", l2p.stats())
    print("fm snapshot:", system.snapshot())
