"""Version constants for the port.

The wire-visible client identity rides in the BEP 10 extended handshake
("v" key) and the Azureus-style peer-id prefix. Both equal the JAX
package's, so the two packages' handshakes are byte-identical and join
the same swarms.
"""

from zest_tpu_torch import __version__

# Azureus-style prefix: ZT = zest-tpu, 01 = v0.1, 00 = patch 0. Client
# identity only; it does not affect swarm interop.
CLIENT_PREFIX = b"-ZT0100-"

# Client string advertised in the BEP 10 extended handshake.
CLIENT_STRING = f"zest-tpu/{__version__}"
