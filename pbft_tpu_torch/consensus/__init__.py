"""The client's part of the consensus layer: the port's trimmed copies of
``pbft_tpu/consensus/messages.py`` (the client request and reply, their
canonical bytes and signable digests) and ``pbft_tpu/consensus/config.py``
(the cluster's ``network.json``), byte-identical on the wire to the JAX
package and to ``pbftd``. The replicas themselves are ``pbftd`` processes
(``core/``); the port runs no Python replica."""
