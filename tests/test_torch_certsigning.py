"""The port's doorman (corda_tpu_torch/crypto/certsigning.py) against the
JAX package's: the mirror of tests/test_certsigning.py, every case run on
both packages, then each package's signer against the other's authority
(the HTTP protocol and the installed file layout are the same)."""

import importlib
import threading
import time
import urllib.error

import pytest
from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

PKGS = ("corda_tpu", "corda_tpu_torch")


def _cs(pkg):
    return importlib.import_module(f"{pkg}.crypto.certsigning")


def _authority(pkg, tmp_path):
    ca_cert, ca_key = importlib.import_module(
        f"{pkg}.crypto.x509").ensure_dev_ca(tmp_path / "shared")
    return _cs(pkg).CertificateSigningServer(ca_cert, ca_key)


@pytest.fixture(params=PKGS)
def pkg_authority(request, tmp_path):
    server = _authority(request.param, tmp_path)
    yield request.param, server
    server.stop()


def make_csr(cn="TestNode"):
    key = ec.generate_private_key(ec.SECP256R1())
    csr = (x509.CertificateSigningRequestBuilder()
           .subject_name(x509.Name(
               [x509.NameAttribute(NameOID.COMMON_NAME, cn)]))
           .sign(key, hashes.SHA256()))
    return key, csr.public_bytes(serialization.Encoding.DER)


def _cn(cert) -> str:
    return cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)[0].value


def test_doorman_approval_workflow(pkg_authority):
    pkg, authority = pkg_authority
    service = _cs(pkg).HttpCertificateSigningService(authority.url)
    _, csr_der = make_csr("Alice Corp")
    request_id = service.submit_request(csr_der)

    assert service.retrieve_certificates(request_id) is None
    assert authority.pending_requests() == {request_id: "Alice Corp"}

    authority.approve(request_id)
    chain = service.retrieve_certificates(request_id)
    assert chain is not None and len(chain) == 2
    leaf, root = chain[0], chain[-1]
    assert _cn(leaf) == "Alice Corp"
    root.public_key().verify(
        leaf.signature, leaf.tbs_certificate_bytes,
        ec.ECDSA(leaf.signature_hash_algorithm))


def test_rejection_raises(pkg_authority):
    pkg, authority = pkg_authority
    service = _cs(pkg).HttpCertificateSigningService(authority.url)
    _, csr_der = make_csr()
    request_id = service.submit_request(csr_der)
    authority.reject(request_id)
    with pytest.raises(_cs(pkg).CertificateRequestRejected):
        service.retrieve_certificates(request_id)


def test_malformed_csr_rejected_at_submit(pkg_authority):
    pkg, authority = pkg_authority
    service = _cs(pkg).HttpCertificateSigningService(authority.url)
    with pytest.raises(urllib.error.HTTPError):
        service.submit_request(b"this is not a CSR")


def test_certificate_signer_end_to_end(tmp_path, pkg_authority):
    pkg, authority = pkg_authority
    authority.auto_approve = True
    service = _cs(pkg).HttpCertificateSigningService(authority.url)
    signer = _cs(pkg).CertificateSigner(tmp_path / "node", "Bank of TPU",
                                        service, poll_interval=0.01)
    paths = signer.build_key_store(timeout=10)
    for p in paths.values():
        assert p.exists()
    leaf = x509.load_pem_x509_certificate(paths["cert"].read_bytes())
    assert _cn(leaf) == "Bank of TPU"
    key = serialization.load_pem_private_key(
        paths["key"].read_bytes(), password=None)
    assert key.public_key().public_numbers() \
        == leaf.public_key().public_numbers()
    before = dict(authority._issued)
    paths2 = signer.build_key_store(timeout=1)
    assert paths2 == paths and authority._issued == before


def test_slow_doorman_approval_completes(tmp_path, pkg_authority):
    """The signer's poll loop survives an authority that approves late; the
    approval waits for the request to be pending, not for a clock."""
    pkg, authority = pkg_authority
    service = _cs(pkg).HttpCertificateSigningService(authority.url)
    signer = _cs(pkg).CertificateSigner(tmp_path / "node", "Slow Corp",
                                        service, poll_interval=0.02)

    def approve_soon():
        for _ in range(200):
            pending = authority.pending_requests()
            if pending:
                authority.approve(next(iter(pending)))
                return
            time.sleep(0.01)

    t = threading.Thread(target=approve_soon)
    t.start()
    paths = signer.build_key_store(timeout=10)
    t.join(timeout=5)
    assert not t.is_alive()
    assert paths["cert"].exists()


@pytest.mark.parametrize("signer_pkg, authority_pkg",
                         [("corda_tpu_torch", "corda_tpu"),
                          ("corda_tpu", "corda_tpu_torch")],
                         ids=["port-signer", "port-authority"])
def test_signer_and_authority_across_packages(tmp_path, signer_pkg,
                                              authority_pkg):
    """One package's CertificateSigner installs a chain from the other's
    authority, in the file layout of x509.generate_dev_tls_material."""
    authority = _authority(authority_pkg, tmp_path)
    try:
        authority.auto_approve = True
        service = _cs(signer_pkg).HttpCertificateSigningService(authority.url)
        paths = _cs(signer_pkg).CertificateSigner(
            tmp_path / "node" / "certificates", "Cross Corp", service,
            poll_interval=0.01).build_key_store(timeout=10)
        assert paths["cert"] == tmp_path / "node" / "certificates" \
            / "tls-cert.pem"
        leaf = x509.load_pem_x509_certificate(paths["cert"].read_bytes())
        root = x509.load_pem_x509_certificate(paths["ca"].read_bytes())
        assert _cn(leaf) == "Cross Corp"
        root.public_key().verify(
            leaf.signature, leaf.tbs_certificate_bytes,
            ec.ECDSA(leaf.signature_hash_algorithm))
    finally:
        authority.stop()
