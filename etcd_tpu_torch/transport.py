"""Transport security: TLS configuration, self-signed cert generation,
and certificate identities for the gateway wire surfaces
(etcd_tpu/transport.py). ``cryptography`` is imported only inside the
functions that make certificates.

The analog of the reference's ``client/pkg/transport`` package
(listener.go:120-180 TLSInfo, listener.go:185 SelfCert,
listener_tls.go:43 NewTLSListener's post-handshake CN/SAN gate) and
``pkg/tlsutil``, re-designed for this framework's HTTP gateway: instead
of Go's crypto/tls listener wrappers, a :class:`TLSInfo` builds
``ssl.SSLContext`` objects for the server socket and for client dials,
and the per-connection identity (client-cert CN) is read off the
handshaked socket by the request handler.

Scope note: in this framework consensus traffic between members of a
group is an on-device tensor exchange (outbox→inbox transpose), not a
socket — so "peer TLS" has no raft wire to protect inside one process.
The TLS surfaces are the client-facing gateway (this module + v3rpc),
the proxies, and any multi-process deployment of those.
"""
from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import os
import ssl

__all__ = [
    "TLSInfo", "self_cert", "generate_ca", "issue_cert",
    "peer_common_name", "check_cert_constraints",
]


@dataclasses.dataclass
class TLSInfo:
    """TLSInfo (client/pkg/transport/listener.go:120-180): file paths +
    policy knobs, from which server/client SSL contexts are built."""

    cert_file: str = ""
    key_file: str = ""
    # separate client-side keypair for dials; falls back to cert_file
    # (listener.go:131-133 ClientCertFile semantics)
    client_cert_file: str = ""
    client_key_file: str = ""
    trusted_ca_file: str = ""
    client_cert_auth: bool = False
    # client dials: skip server-cert verification entirely
    insecure_skip_verify: bool = False
    # post-handshake constraints (listener.go:161-166): a CN the client
    # cert must carry, or a hostname/IP its SANs must cover. (The
    # reference's SkipClientSANVerify has no analog: client-cert SANs
    # are never verified here unless allowed_hostname opts in, so there
    # is nothing to skip.)
    allowed_cn: str = ""
    allowed_hostname: str = ""

    def empty(self) -> bool:
        return not self.cert_file and not self.key_file

    def __str__(self) -> str:
        return (f"cert = {self.cert_file}, key = {self.key_file}, "
                f"trusted-ca = {self.trusted_ca_file}, "
                f"client-cert-auth = {self.client_cert_auth}")

    # ---------------------------------------------------------- contexts
    def server_context(self) -> ssl.SSLContext:
        """ServerConfig (listener.go:345-380): server cert + optional
        required-and-verified client certs."""
        if not self.cert_file or not self.key_file:
            raise ValueError(
                "KeyFile and CertFile must both be present "
                f"[key: {self.key_file!r}, cert: {self.cert_file!r}]")
        wants_client_certs = self.client_cert_auth or self.allowed_cn \
            or self.allowed_hostname
        if wants_client_certs and not self.trusted_ca_file:
            raise ValueError("client cert auth requires a trusted CA file")
        if self.allowed_cn and self.allowed_hostname:
            # mutually exclusive like the reference's ServerConfig
            # (listener.go:354): silently preferring one would void the
            # other constraint the operator thinks is enforced
            raise ValueError(
                "AllowedCN and AllowedHostname are mutually exclusive")
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(self.cert_file, self.key_file)
        if wants_client_certs:
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(self.trusted_ca_file)
        elif self.trusted_ca_file:
            # CA without required certs: verify one when presented
            ctx.verify_mode = ssl.CERT_OPTIONAL
            ctx.load_verify_locations(self.trusted_ca_file)
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """ClientConfig (listener.go:382-403): CA verification for the
        server cert + optional client keypair for mutual TLS."""
        if self.insecure_skip_verify:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        elif self.trusted_ca_file:
            ctx = ssl.create_default_context(
                cafile=self.trusted_ca_file)
        else:
            ctx = ssl.create_default_context()
        cert = self.client_cert_file or self.cert_file
        key = self.client_key_file or self.key_file
        if bool(cert) != bool(key):
            # a half-configured keypair must error here, not surface
            # later as an opaque handshake rejection (listener.go:358)
            raise ValueError(
                "ClientCertFile and ClientKeyFile must both be present "
                f"or both absent [cert: {cert!r}, key: {key!r}]")
        if cert and key:
            ctx.load_cert_chain(cert, key)
        return ctx


def resolve_client_context(tls) -> "ssl.SSLContext | None":
    """One resolution rule for every client transport: a TLSInfo builds
    its client context; a prebuilt ssl.SSLContext passes through; None
    stays None (plain http)."""
    if tls is None:
        return None
    if hasattr(tls, "client_context"):
        return tls.client_context()
    return tls


# ------------------------------------------------------- cert generation

_ONE_DAY = datetime.timedelta(days=1)


def _new_key():
    from cryptography.hazmat.primitives.asymmetric import ec

    return ec.generate_private_key(ec.SECP256R1())


def _write_pem(cert, key, cert_path: str, key_path: str) -> None:
    """Write key THEN cert, each via tmp-file + rename: the reuse guard
    checks for both files, so writing the cert last means 'cert.pem
    exists' implies a complete keypair — a crash mid-generation can
    never leave a permanently broken pair behind."""
    from cryptography.hazmat.primitives import serialization

    tmp_key = key_path + ".tmp"
    fd = os.open(tmp_key, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp_key, key_path)
    tmp_cert = cert_path + ".tmp"
    with open(tmp_cert, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp_cert, cert_path)
    # fsync the directory so the renames themselves survive power loss
    dfd = os.open(os.path.dirname(cert_path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _san_entries(hosts):
    from cryptography import x509

    out = []
    for host in hosts or ():
        h = host.rsplit(":", 1)[0] if ":" in host and \
            host.count(":") == 1 else host
        try:
            out.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            out.append(x509.DNSName(h))
    return out


def _build_cert(subject_cn: str, hosts, issuer_cert, issuer_key, key,
                is_ca: bool, validity_days: int, server_auth: bool,
                client_auth: bool):
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    subject = x509.Name([
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, "etcd-tpu"),
        x509.NameAttribute(NameOID.COMMON_NAME, subject_cn),
    ])
    issuer = subject if issuer_cert is None else issuer_cert.subject
    now = datetime.datetime.now(datetime.timezone.utc)
    b = (x509.CertificateBuilder()
         .subject_name(subject)
         .issuer_name(issuer)
         .public_key(key.public_key())
         .serial_number(x509.random_serial_number())
         .not_valid_before(now - _ONE_DAY)
         .not_valid_after(now + datetime.timedelta(days=validity_days))
         .add_extension(x509.BasicConstraints(ca=is_ca, path_length=None),
                        critical=True)
         .add_extension(x509.KeyUsage(
             digital_signature=True, key_encipherment=not is_ca,
             content_commitment=False, data_encipherment=False,
             key_agreement=False, key_cert_sign=is_ca, crl_sign=is_ca,
             encipher_only=False, decipher_only=False), critical=True))
    if not is_ca:
        ekus = []
        if server_auth:
            ekus.append(ExtendedKeyUsageOID.SERVER_AUTH)
        if client_auth:
            ekus.append(ExtendedKeyUsageOID.CLIENT_AUTH)
        b = b.add_extension(x509.ExtendedKeyUsage(ekus), critical=False)
    san = _san_entries(hosts)
    if san:
        b = b.add_extension(x509.SubjectAlternativeName(san),
                            critical=False)
    signer = issuer_key if issuer_key is not None else key
    return b.sign(signer, hashes.SHA256())


def self_cert(dirpath: str, hosts, validity_days: int = 365,
              common_name: str = "etcd-tpu-self") -> TLSInfo:
    """SelfCert (listener.go:185-280): generate (or reuse) a self-signed
    keypair under `dirpath` covering `hosts` as SANs; the same keypair
    serves as server cert and client cert, like the reference's
    auto-TLS. Returns the TLSInfo pointing at cert.pem/key.pem with the
    cert itself as the trust root (self-signed ⇒ it is its own CA)."""
    os.makedirs(dirpath, exist_ok=True)
    cert_path = os.path.abspath(os.path.join(dirpath, "cert.pem"))
    key_path = os.path.abspath(os.path.join(dirpath, "key.pem"))
    if not (os.path.exists(cert_path) and os.path.exists(key_path)):
        key = _new_key()
        cert = _build_cert(common_name, hosts, None, None, key,
                           is_ca=True, validity_days=validity_days,
                           server_auth=True, client_auth=True)
        _write_pem(cert, key, cert_path, key_path)
    return TLSInfo(cert_file=cert_path, key_file=key_path,
                   client_cert_file=cert_path, client_key_file=key_path,
                   trusted_ca_file=cert_path)


def generate_ca(dirpath: str, validity_days: int = 365,
                common_name: str = "etcd-tpu-ca") -> TLSInfo:
    """A private CA for issuing server/client certs (the analog of the
    reference test fixtures' CA; no direct reference function — SelfCert
    only does self-signed). Returns a TLSInfo whose trusted_ca_file is
    the CA cert; cert/key are the CA's own (for issue_cert)."""
    os.makedirs(dirpath, exist_ok=True)
    cert_path = os.path.abspath(os.path.join(dirpath, "ca.pem"))
    key_path = os.path.abspath(os.path.join(dirpath, "ca-key.pem"))
    if not (os.path.exists(cert_path) and os.path.exists(key_path)):
        key = _new_key()
        cert = _build_cert(common_name, (), None, None, key, is_ca=True,
                           validity_days=validity_days,
                           server_auth=False, client_auth=False)
        _write_pem(cert, key, cert_path, key_path)
    return TLSInfo(cert_file=cert_path, key_file=key_path,
                   trusted_ca_file=cert_path)


def _load_ca(ca: TLSInfo):
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    with open(ca.cert_file, "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    with open(ca.key_file, "rb") as f:
        key = serialization.load_pem_private_key(f.read(), password=None)
    return cert, key


def issue_cert(dirpath: str, ca: TLSInfo, common_name: str,
               hosts=(), validity_days: int = 365,
               server_auth: bool = True,
               client_auth: bool = True) -> TLSInfo:
    """Issue a leaf cert signed by `ca` with the given CN and SANs —
    the identity carrier for cert-CN auth (server/auth/store.go:985
    AuthInfoFromTLS takes the verified chain's CommonName as the user)."""
    os.makedirs(dirpath, exist_ok=True)
    base = common_name.replace("/", "_")
    cert_path = os.path.abspath(os.path.join(dirpath, f"{base}.pem"))
    key_path = os.path.abspath(
        os.path.join(dirpath, f"{base}-key.pem"))
    if not (os.path.exists(cert_path) and os.path.exists(key_path)):
        ca_cert, ca_key = _load_ca(ca)
        key = _new_key()
        cert = _build_cert(common_name, hosts, ca_cert, ca_key, key,
                           is_ca=False, validity_days=validity_days,
                           server_auth=server_auth,
                           client_auth=client_auth)
        _write_pem(cert, key, cert_path, key_path)
    return TLSInfo(cert_file=cert_path, key_file=key_path,
                   trusted_ca_file=ca.trusted_ca_file or ca.cert_file)


# ------------------------------------------------- connection identities

def peer_common_name(conn) -> str | None:
    """The verified client cert's CN off a handshaked SSL socket, or
    None (plain socket / no client cert / unverified). Only verified
    certs carry identity — ssl only exposes getpeercert() content when
    verify_mode required/optional verification succeeded, mirroring the
    reference's use of VerifiedChains (store.go:992)."""
    getpeercert = getattr(conn, "getpeercert", None)
    if getpeercert is None:
        return None
    cert = getpeercert()
    if not cert:
        return None
    for rdn in cert.get("subject", ()):
        for k, v in rdn:
            if k == "commonName":
                return v
    return None


def check_cert_constraints(conn, allowed_cn: str = "",
                           allowed_hostname: str = "") -> bool:
    """The post-handshake gate of NewTLSListener (listener_tls.go:43,
    check 'allowed CN'/'allowed hostname'): True iff the peer cert
    satisfies the configured constraint. No constraints ⇒ pass."""
    if not allowed_cn and not allowed_hostname:
        return True
    cert = conn.getpeercert() if hasattr(conn, "getpeercert") else None
    if not cert:
        return False
    if allowed_cn:
        return peer_common_name(conn) == allowed_cn
    # hostname constraint: the cert's SANs must cover it (wildcard
    # matching via ssl's private helper, exact match if it ever moves)
    for typ, val in cert.get("subjectAltName", ()):
        if typ == "IP Address" and val == allowed_hostname:
            return True
        if typ == "DNS":
            try:
                if ssl._dnsname_match(val, allowed_hostname):
                    return True
            except AttributeError:  # pragma: no cover
                if val == allowed_hostname:
                    return True
    return False
