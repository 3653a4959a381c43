"""The port's dev-mode TLS material (corda_tpu_torch/crypto/x509.py) and
mutual TLS between the packages' nodes.

The port's certificates chain to the same shared dev CA, in the same file
layout, as the JAX package's: each package's node certificate verifies
against the other's CA, a port node and a JAX node sharing the network
map's directory notarise over mutual TLS, and a node whose certificate a
doorman issued (crypto/certsigning.py) joins the same TLS network.
"""

import importlib
import time
from types import SimpleNamespace

import pytest
from cryptography import x509
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

from corda_tpu_torch.testing import notary_load as nl

PKGS = ("corda_tpu", "corda_tpu_torch")


def _x509(pkg):
    return importlib.import_module(f"{pkg}.crypto.x509")


def _chains(leaf_pem: bytes, ca_pem: bytes) -> bool:
    leaf = x509.load_pem_x509_certificate(leaf_pem)
    ca = x509.load_pem_x509_certificate(ca_pem)
    ca.public_key().verify(leaf.signature, leaf.tbs_certificate_bytes,
                           ec.ECDSA(leaf.signature_hash_algorithm))
    return leaf.issuer == ca.subject


@pytest.mark.parametrize("pkg", PKGS)
def test_dev_ca_is_made_once_and_reused(tmp_path, pkg):
    first = _x509(pkg).ensure_dev_ca(tmp_path)
    pem = first[0].read_bytes()
    assert _x509(pkg).ensure_dev_ca(tmp_path) == first
    assert first[0].read_bytes() == pem
    ca = x509.load_pem_x509_certificate(pem)
    assert ca.subject.get_attributes_for_oid(
        NameOID.COMMON_NAME)[0].value == "corda_tpu Dev Root CA"


@pytest.mark.parametrize("ca_pkg, node_pkg",
                         [(a, b) for a in PKGS for b in PKGS])
def test_node_material_chains_to_either_packages_ca(tmp_path, ca_pkg,
                                                    node_pkg):
    _x509(ca_pkg).ensure_dev_ca(tmp_path)
    paths = _x509(node_pkg).generate_dev_tls_material(
        tmp_path / "Alice", tmp_path, "Alice")
    assert paths == {"ca": tmp_path / "dev-ca.pem",
                     "cert": tmp_path / "Alice" / "certificates"
                     / "tls-cert.pem",
                     "key": tmp_path / "Alice" / "certificates"
                     / "tls-key.pem"}
    assert _chains(paths["cert"].read_bytes(), paths["ca"].read_bytes())
    leaf = x509.load_pem_x509_certificate(paths["cert"].read_bytes())
    assert leaf.subject.get_attributes_for_oid(
        NameOID.COMMON_NAME)[0].value == "Alice"
    # Idempotent: a restart reuses the files.
    again = _x509(node_pkg).generate_dev_tls_material(
        tmp_path / "Alice", tmp_path, "Alice")
    assert again == paths and again["cert"].read_bytes() == \
        paths["cert"].read_bytes()


def _api(pkg):
    m = lambda path: importlib.import_module(f"{pkg}.{path}")  # noqa: E731
    return SimpleNamespace(
        Node=m("node.node").Node, NodeConfig=m("node.config").NodeConfig,
        NodeDatabase=m("node.services.persistence").NodeDatabase,
        NotaryClientFlow=m("flows.notary").NotaryClientFlow,
        DummyContract=m("testing.dummies").DummyContract)


def _tls_node(api, base, name, notary="none"):
    node_dir = base / name
    node_dir.mkdir(parents=True, exist_ok=True)
    db = api.NodeDatabase(node_dir / "node.db")
    db.load_or_create_identity(name, nl.node_seed(name))
    db.close()
    return api.Node(api.NodeConfig(
        name=name, base_dir=node_dir, port=0, notary=notary,
        network_map=base / "netmap.json", verifier="cpu", tls=True)).start()


def _notarise(api, nodes, alice, notary, bob, n=4):
    for node in nodes:
        node.refresh_netmap()
    seen = next(i.legal_identity for i in alice.network_map_cache.party_nodes
                if i.legal_identity.name == "Notary")
    work = nl.build_workload(api, SimpleNamespace(identity=seen), alice, bob,
                             n, 1, 1, 11)
    alice.services.record_transactions(work.issues)
    handles = [alice.start_flow(api.NotaryClientFlow(s))
               for s in work.moves + work.doubles]
    deadline = time.monotonic() + 60
    while not all(h.result.done for h in handles):
        assert time.monotonic() < deadline, "the TLS nodes did not settle"
        for node in nodes:
            node.run_once(timeout=0.005)
    kinds = [nl.outcome_of(h) for h in handles]
    assert [k[:1] if k[0] == "ok" else k for k in kinds] == \
        nl.expected_outcomes(work)
    # Every move but the tampered one commits; the second spend conflicts.
    return notary.uniqueness_provider.committed_count


@pytest.mark.parametrize("client_pkg, notary_pkg",
                         [("corda_tpu", "corda_tpu_torch"),
                          ("corda_tpu_torch", "corda_tpu")],
                         ids=["jax-alice-port-notary", "port-alice-jax-notary"])
def test_the_packages_notarise_over_mutual_tls(tmp_path, client_pkg,
                                               notary_pkg):
    """A port node and a JAX node sharing the network map's directory (and
    so its dev CA) notarise over mutual TLS."""
    client, server = _api(client_pkg), _api(notary_pkg)
    notary = _tls_node(server, tmp_path, "Notary", notary="simple")
    alice = _tls_node(client, tmp_path, "Alice")
    bob = _tls_node(client, tmp_path, "Bob")
    nodes = [notary, alice, bob]
    try:
        assert all(n.messaging._tls_server_ctx is not None for n in nodes)
        assert _notarise(client, nodes, alice, notary, bob) == 3
    finally:
        for node in nodes:
            node.stop()


def test_a_doorman_issued_certificate_joins_the_tls_network(tmp_path):
    """Alice's certificate comes from a CertificateSigningServer over HTTP
    (CertificateSigner, into the node's certificates directory); the
    others' from the dev CA beside the network map, which the doorman
    also signs with. The port's nodes notarise over mutual TLS."""
    from corda_tpu_torch.crypto import certsigning, x509 as px509

    ca_cert, ca_key = px509.ensure_dev_ca(tmp_path)
    doorman = certsigning.CertificateSigningServer(ca_cert, ca_key,
                                                   auto_approve=True)
    try:
        service = certsigning.HttpCertificateSigningService(doorman.url)
        issued = certsigning.CertificateSigner(
            tmp_path / "Alice" / "certificates", "Alice", service,
            poll_interval=0.01).build_key_store(timeout=10)
    finally:
        doorman.stop()
    pem = issued["cert"].read_bytes()
    api = _api("corda_tpu_torch")
    notary = _tls_node(api, tmp_path, "Notary", notary="simple")
    alice = _tls_node(api, tmp_path, "Alice")
    bob = _tls_node(api, tmp_path, "Bob")
    nodes = [notary, alice, bob]
    try:
        # The node kept the doorman's certificate rather than minting one.
        assert issued["cert"].read_bytes() == pem
        assert _chains(pem, ca_cert.read_bytes())
        assert _notarise(api, nodes, alice, notary, bob) == 3
    finally:
        for node in nodes:
            node.stop()
