"""TLS utilities: certificate generation + ssl contexts for the gossip plane.

The reference secures QUIC gossip with rustls and generates certificates
with rcgen (`corrosion tls ca/server/client generate`,
corrosion/src/command/tls.rs:1-94; server/client configs incl. the mTLS
client verifier, corro-agent/src/api/peer.rs:132-313). Here the TCP gossip
plane is wrapped with stdlib ``ssl`` and certificates come from the
``cryptography`` package (the rcgen role):

- ``generate_ca(dir)``            → ca_cert.pem + ca_key.pem (self-signed)
- ``generate_server_cert(...)``   → cert.pem + key.pem signed by the CA,
                                    SAN = the gossip addr's host
- ``generate_client_cert(...)``   → client-auth cert for mTLS
- ``server_ssl_context(...)``     → accepts gossip connections; optionally
                                    requires + verifies client certs (mTLS)
- ``client_ssl_context(...)``     → verifies the server against the CA;
                                    ``insecure=True`` mirrors the
                                    reference's `insecure = true` config
                                    (skip name/chain verification)

Counterpart of corrosion_tpu/agent/tls.py.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from dataclasses import dataclass

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

CA_CERT = "ca_cert.pem"
CA_KEY = "ca_key.pem"
SERVER_CERT = "cert.pem"
SERVER_KEY = "key.pem"
CLIENT_CERT = "client_cert.pem"
CLIENT_KEY = "client_key.pem"


@dataclass(frozen=True)
class CertPaths:
    cert: str
    key: str


def _write_key_cert(
    directory: str, key, cert, key_name: str, cert_name: str
) -> CertPaths:
    os.makedirs(directory, exist_ok=True)
    key_path = os.path.join(directory, key_name)
    cert_path = os.path.join(directory, cert_name)
    with open(key_path, "wb") as f:
        os.fchmod(f.fileno(), 0o600)
        f.write(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            )
        )
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    return CertPaths(cert=cert_path, key=key_path)


def _name(common_name: str) -> x509.Name:
    return x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    )


def _validity():
    now = datetime.datetime.now(datetime.timezone.utc)
    return now - datetime.timedelta(hours=1), now + datetime.timedelta(
        days=3650
    )


def generate_ca(directory: str) -> CertPaths:
    """Self-signed CA (tls.rs `generate_ca`)."""
    key = ec.generate_private_key(ec.SECP256R1())
    not_before, not_after = _validity()
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name("corrosion-tpu CA"))
        .issuer_name(_name("corrosion-tpu CA"))
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(not_before)
        .not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True,
                key_cert_sign=True,
                crl_sign=True,
                content_commitment=False,
                key_encipherment=False,
                data_encipherment=False,
                key_agreement=False,
                encipher_only=False,
                decipher_only=False,
            ),
            True,
        )
        .sign(key, hashes.SHA256())
    )
    return _write_key_cert(directory, key, cert, CA_KEY, CA_CERT)


def _load_ca(ca_dir: str):
    with open(os.path.join(ca_dir, CA_KEY), "rb") as f:
        ca_key = serialization.load_pem_private_key(f.read(), None)
    with open(os.path.join(ca_dir, CA_CERT), "rb") as f:
        ca_cert = x509.load_pem_x509_certificate(f.read())
    return ca_key, ca_cert


def _signed_cert(ca_dir: str, common_name: str, eku, sans=None):
    ca_key, ca_cert = _load_ca(ca_dir)
    key = ec.generate_private_key(ec.SECP256R1())
    not_before, not_after = _validity()
    builder = (
        x509.CertificateBuilder()
        .subject_name(_name(common_name))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(not_before)
        .not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), True)
        .add_extension(x509.ExtendedKeyUsage([eku]), False)
    )
    if sans:
        alt_names = []
        for san in sans:
            try:
                alt_names.append(
                    x509.IPAddress(ipaddress.ip_address(san))
                )
            except ValueError:
                alt_names.append(x509.DNSName(san))
        builder = builder.add_extension(
            x509.SubjectAlternativeName(alt_names), False
        )
    return key, builder.sign(ca_key, hashes.SHA256())


def generate_server_cert(
    directory: str, ca_dir: str, host: str
) -> CertPaths:
    """Server cert for the gossip addr's host (tls.rs `generate_server_cert`
    uses config.gossip.addr's IP as the SAN)."""
    key, cert = _signed_cert(
        ca_dir,
        host,
        ExtendedKeyUsageOID.SERVER_AUTH,
        sans=[host],
    )
    return _write_key_cert(directory, key, cert, SERVER_KEY, SERVER_CERT)


def generate_client_cert(directory: str, ca_dir: str) -> CertPaths:
    """Client-auth cert for mTLS (tls.rs `generate_client_cert`)."""
    key, cert = _signed_cert(
        ca_dir, "corrosion-tpu client", ExtendedKeyUsageOID.CLIENT_AUTH
    )
    return _write_key_cert(directory, key, cert, CLIENT_KEY, CLIENT_CERT)


def server_ssl_context(
    cert: str, key: str, ca_cert: str | None = None,
    require_client_cert: bool = False,
) -> ssl.SSLContext:
    """Gossip-server context (peer.rs:132-213). ``require_client_cert``
    enables the mTLS client verifier against the CA."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    ctx.load_cert_chain(cert, key)
    if require_client_cert:
        if ca_cert is None:
            raise ValueError("mTLS requires the CA certificate")
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(ca_cert)
    return ctx


def client_ssl_context(
    ca_cert: str | None = None,
    cert: str | None = None,
    key: str | None = None,
    insecure: bool = False,
) -> ssl.SSLContext:
    """Gossip-client context (peer.rs:221-313); pass cert+key for mTLS.
    ``insecure`` skips chain/name verification (config `insecure = true`).

    Fails closed: verification without a CA would leave an empty trust
    store whose every handshake error the transport swallows as a generic
    connection failure — a silent never-syncs outage — so it is rejected
    here at build time instead.
    """
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    if insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    elif ca_cert is not None:
        ctx.load_verify_locations(ca_cert)
    else:
        raise ValueError(
            "client TLS without a CA certificate: pass ca_cert (the "
            "cluster CA) or insecure=True"
        )
    if cert and key:
        ctx.load_cert_chain(cert, key)
    return ctx
