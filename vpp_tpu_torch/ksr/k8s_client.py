"""Real Kubernetes list-watch sources for the KSR reflectors.

The port's copy of ``vpp_tpu/ksr/k8s_client.py``: ``K8sListWatch``
against a live API server over its REST interface — list + streaming
watch with resourceVersion continuation. Where the reference speaks HTTP
through ``requests``, this copy uses the standard library only
(``http.client`` and ``ssl``): the machines the port runs on need not
carry ``requests``. The watch stream is read line by line off the
chunked response (``HTTPResponse.readline`` decodes the chunks).

Reference: plugins/ksr/pod_reflector.go:39-142 (client-go ListWatch +
converters), ksr_reflector.go:185-232 (resync on reconnect). Reconnect
handling follows the informer pattern: on stream loss or 410 Gone the
source re-lists and *diffs against its own cache*, synthesizing
add/update/delete callbacks — so the Reflector above never needs to know
a reconnect happened. A subscriber's baseline is what ``list()`` returns
(the reflector's resync lists right after it subscribes): the watch
thread's first list, when it runs before any ``list()``, only fills the
cache. The reference's dispatches an add for every object into a
reflector whose resync is still running, so its KSR writes each listed
object once, twice or three times, as its threads happen to run; the
port writes it once.

Auth: kubeconfig file (token / client cert / CA, with inline base64
``*-data`` variants; JSON, or YAML where PyYAML is installed) or the
in-cluster service-account mount.
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import os
import ssl
import tempfile
import threading
import urllib.parse
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from vpp_tpu_torch.ksr import model
from vpp_tpu_torch.ksr.reflector import K8sListWatch

log = logging.getLogger("k8s_client")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# temp files holding materialized kubeconfig data (may include TLS client
# keys) — scrubbed at process exit
_materialized_paths: list = []


def _cleanup_materialized() -> None:
    for path in _materialized_paths:
        try:
            os.unlink(path)
        except OSError:
            pass
    _materialized_paths.clear()


# --------------------------------------------------------------------------
# configuration / auth
# --------------------------------------------------------------------------

@dataclass
class K8sApiConfig:
    server: str                           # e.g. https://10.0.0.1:6443
    token: Optional[str] = None
    ca_file: Optional[str] = None         # None -> verify with system CAs
    client_cert: Optional[Tuple[str, str]] = None   # (cert_file, key_file)
    verify_tls: bool = True

    @staticmethod
    def _materialize(b64: str, suffix: str) -> str:
        """Write inline base64 kubeconfig data to a temp file for the
        TLS context. Files (0600 by NamedTemporaryFile default) are removed
        at process exit — client private keys must not outlive us."""
        f = tempfile.NamedTemporaryFile(
            mode="wb", suffix=suffix, delete=False, prefix="vpp-tpu-k8s-"
        )
        with f:
            f.write(base64.b64decode(b64))
        if not _materialized_paths:
            import atexit

            atexit.register(_cleanup_materialized)
        _materialized_paths.append(f.name)
        return f.name

    @classmethod
    def from_kubeconfig(cls, path: str,
                        context: Optional[str] = None) -> "K8sApiConfig":
        with open(path) as fh:
            text = fh.read()
        try:
            cfg = json.loads(text)
        except ValueError:
            import yaml

            cfg = yaml.safe_load(text)
        if not isinstance(cfg, dict):
            raise ValueError(f"kubeconfig {path}: not a mapping")
        by_name = lambda items: {i["name"]: i for i in (items or [])}
        contexts = by_name(cfg.get("contexts"))
        clusters = by_name(cfg.get("clusters"))
        users = by_name(cfg.get("users"))
        ctx_name = context or cfg.get("current-context")
        if not ctx_name or ctx_name not in contexts:
            raise ValueError(f"kubeconfig {path}: no usable context")
        ctx = contexts[ctx_name]["context"]
        cluster = clusters[ctx["cluster"]]["cluster"]
        user = users.get(ctx.get("user", ""), {}).get("user", {})

        ca_file = cluster.get("certificate-authority")
        if cluster.get("certificate-authority-data"):
            ca_file = cls._materialize(
                cluster["certificate-authority-data"], ".crt"
            )
        client_cert = None
        cert = user.get("client-certificate")
        key = user.get("client-key")
        if user.get("client-certificate-data"):
            cert = cls._materialize(user["client-certificate-data"], ".crt")
        if user.get("client-key-data"):
            key = cls._materialize(user["client-key-data"], ".key")
        if cert and key:
            client_cert = (cert, key)
        return cls(
            server=cluster["server"],
            token=user.get("token"),
            ca_file=ca_file,
            client_cert=client_cert,
            verify_tls=not cluster.get("insecure-skip-tls-verify", False),
        )

    @classmethod
    def in_cluster(cls) -> "K8sApiConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError("not running in a cluster "
                               "(KUBERNETES_SERVICE_HOST unset)")
        with open(os.path.join(SERVICE_ACCOUNT_DIR, "token")) as fh:
            token = fh.read().strip()
        return cls(
            server=f"https://{host}:{port}",
            token=token,
            ca_file=os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt"),
        )


class K8sApiError(OSError):
    """An HTTP error status from the API server (the reference's
    ``requests.HTTPError`` from ``raise_for_status``)."""

    def __init__(self, status: int, reason: str, url: str):
        super().__init__(f"{status} {reason} for url: {url}")
        self.status = status


class K8sApi:
    """Minimal REST client: GET list + chunked watch stream, over
    ``http.client`` (one connection a request: a watch holds its own
    for the stream's life)."""

    def __init__(self, config: K8sApiConfig, timeout: float = 30.0):
        self.config = config
        self.timeout = timeout
        url = urllib.parse.urlsplit(config.server)
        if url.scheme not in ("http", "https") or not url.hostname:
            raise ValueError(f"bad API server url: {config.server!r}")
        self._https = url.scheme == "https"
        self._host = url.hostname
        self._port = url.port
        self._base = url.path.rstrip("/")
        self._headers = {"Accept": "application/json"}
        if config.token:
            self._headers["Authorization"] = f"Bearer {config.token}"
        self._ssl: Optional[ssl.SSLContext] = None
        if self._https:
            if not config.verify_tls:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            else:
                ctx = ssl.create_default_context(cafile=config.ca_file)
            if config.client_cert:
                ctx.load_cert_chain(*config.client_cert)
            self._ssl = ctx

    def close(self) -> None:
        """Nothing pooled to close (each request owns its connection)."""

    def _get(self, path: str, timeout: float):
        """(connection, response) of a GET; an error status raises
        ``K8sApiError`` with the connection closed."""
        if self._https:
            conn = http.client.HTTPSConnection(
                self._host, self._port, timeout=timeout, context=self._ssl)
        else:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=timeout)
        try:
            conn.request("GET", self._base + path, headers=self._headers)
            resp = conn.getresponse()
            if resp.status >= 400:
                resp.read()
                raise K8sApiError(resp.status, resp.reason,
                                  self.config.server + path)
        except BaseException:
            conn.close()
            raise
        return conn, resp

    def get_list(self, path: str) -> Dict[str, Any]:
        conn, resp = self._get(path, self.timeout)
        try:
            return json.loads(resp.read())
        finally:
            conn.close()

    def watch(self, path: str, resource_version: str,
              timeout_seconds: int = 300) -> Iterator[Dict[str, Any]]:
        """Yield watch events until the server ends the stream.

        The caller owns reconnect policy; a 410 Gone surfaces as an
        ``ERROR``-type event per the K8s watch protocol. A read stalls
        at most ``timeout_seconds + 30`` s (the reference's read
        timeout) before it raises.
        """
        sep = "&" if "?" in path else "?"
        url = (f"{path}{sep}watch=true"
               f"&resourceVersion={resource_version}"
               f"&allowWatchBookmarks=true"
               f"&timeoutSeconds={timeout_seconds}")
        conn, resp = self._get(url, timeout_seconds + 30)
        try:
            while True:
                line = resp.readline()
                if not line:
                    return
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            conn.close()


# --------------------------------------------------------------------------
# raw K8s JSON -> vpp_tpu_torch.ksr.model converters
# (reference: the *Reflector converter funcs, e.g. pod_reflector.go:96-142)
# --------------------------------------------------------------------------

def _meta(obj: Dict[str, Any]) -> Dict[str, Any]:
    return obj.get("metadata") or {}


def convert_pod(obj: Dict[str, Any]) -> model.Pod:
    meta, spec = _meta(obj), obj.get("spec") or {}
    status = obj.get("status") or {}
    containers = []
    for c in spec.get("containers") or []:
        ports = [
            model.ContainerPort(
                name=p.get("name", ""),
                container_port=p.get("containerPort", 0),
                host_port=p.get("hostPort", 0),
                protocol=p.get("protocol", "TCP"),
            )
            for p in c.get("ports") or []
        ]
        containers.append(model.Container(name=c.get("name", ""), ports=ports))
    return model.Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", ""),
        labels=dict(meta.get("labels") or {}),
        ip_address=status.get("podIP", ""),
        host_ip_address=status.get("hostIP", ""),
        containers=containers,
    )


def convert_namespace(obj: Dict[str, Any]) -> model.Namespace:
    meta = _meta(obj)
    return model.Namespace(
        name=meta.get("name", ""),
        labels=dict(meta.get("labels") or {}),
    )


def _convert_selector(sel: Optional[Dict[str, Any]]) -> model.LabelSelector:
    sel = sel or {}
    return model.LabelSelector(
        match_labels=dict(sel.get("matchLabels") or {}),
        match_expressions=[
            model.LabelExpression(
                key=e.get("key", ""),
                operator=e.get("operator", ""),
                values=list(e.get("values") or []),
            )
            for e in sel.get("matchExpressions") or []
        ],
    )


def _convert_policy_rules(rules: List[Dict[str, Any]],
                          peer_field: str) -> List[model.PolicyRule]:
    out = []
    for r in rules or []:
        ports = []
        for p in r.get("ports") or []:
            port = p.get("port")
            ports.append(model.PolicyPort(
                protocol=p.get("protocol", "TCP"),
                port=port if isinstance(port, int) else None,
                port_name=port if isinstance(port, str) else "",
            ))
        peers = []
        for peer in r.get(peer_field) or []:
            ip_block = None
            if peer.get("ipBlock"):
                ip_block = model.IPBlock(
                    cidr=peer["ipBlock"].get("cidr", ""),
                    except_cidrs=list(peer["ipBlock"].get("except") or []),
                )
            peers.append(model.PolicyPeer(
                pods=(_convert_selector(peer["podSelector"])
                      if "podSelector" in peer else None),
                namespaces=(_convert_selector(peer["namespaceSelector"])
                            if "namespaceSelector" in peer else None),
                ip_block=ip_block,
            ))
        out.append(model.PolicyRule(ports=ports, peers=peers))
    return out


def convert_policy(obj: Dict[str, Any]) -> model.Policy:
    meta, spec = _meta(obj), obj.get("spec") or {}
    types = set(spec.get("policyTypes") or [])
    if types == {"Ingress"}:
        ptype = model.POLICY_INGRESS
    elif types == {"Egress"}:
        ptype = model.POLICY_EGRESS
    elif types == {"Ingress", "Egress"}:
        ptype = model.POLICY_BOTH
    else:
        # absent policyTypes: K8s defaulting (Ingress always; Egress iff
        # egress rules present) — the reference's DEFAULT handling that
        # policy/processor resolves (processor.go DEFAULT branch).
        ptype = model.POLICY_DEFAULT
    return model.Policy(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", ""),
        labels=dict(meta.get("labels") or {}),
        pods=_convert_selector(spec.get("podSelector")),
        policy_type=ptype,
        ingress_rules=_convert_policy_rules(spec.get("ingress"), "from"),
        egress_rules=_convert_policy_rules(spec.get("egress"), "to"),
    )


def convert_service(obj: Dict[str, Any]) -> model.Service:
    meta, spec = _meta(obj), obj.get("spec") or {}
    ports = []
    for p in spec.get("ports") or []:
        ports.append(model.ServicePort(
            name=p.get("name", ""),
            protocol=p.get("protocol", "TCP"),
            port=p.get("port", 0),
            target_port=p.get("targetPort", p.get("port", 0)),
            node_port=p.get("nodePort", 0),
        ))
    return model.Service(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", ""),
        ports=ports,
        selector=dict(spec.get("selector") or {}),
        cluster_ip=spec.get("clusterIP", ""),
        service_type=spec.get("type", "ClusterIP"),
        external_ips=list(spec.get("externalIPs") or []),
        external_traffic_policy=spec.get("externalTrafficPolicy", "Cluster"),
    )


def convert_endpoints(obj: Dict[str, Any]) -> model.Endpoints:
    meta = _meta(obj)

    def addr(a: Dict[str, Any]) -> model.EndpointAddress:
        ref = a.get("targetRef") or {}
        target = ""
        if ref.get("kind") == "Pod" and ref.get("name"):
            target = f"{ref.get('namespace', '')}/{ref['name']}"
        return model.EndpointAddress(
            ip=a.get("ip", ""),
            node_name=a.get("nodeName", ""),
            target_pod=target,
        )

    subsets = []
    for s in obj.get("subsets") or []:
        subsets.append(model.EndpointSubset(
            addresses=[addr(a) for a in s.get("addresses") or []],
            not_ready_addresses=[
                addr(a) for a in s.get("notReadyAddresses") or []
            ],
            ports=[
                model.EndpointPort(
                    name=p.get("name", ""),
                    port=p.get("port", 0),
                    protocol=p.get("protocol", "TCP"),
                )
                for p in s.get("ports") or []
            ],
        ))
    return model.Endpoints(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", ""),
        subsets=subsets,
    )


def convert_node(obj: Dict[str, Any]) -> model.Node:
    meta = _meta(obj)
    status = obj.get("status") or {}
    spec = obj.get("spec") or {}
    return model.Node(
        name=meta.get("name", ""),
        addresses=[
            model.NodeAddress(type=a.get("type", ""),
                              address=a.get("address", ""))
            for a in status.get("addresses") or []
        ],
        pod_cidr=spec.get("podCIDR", ""),
    )


@dataclass
class _Resource:
    obj_type: str                             # ksr model TYPE
    path: str                                 # list path (cluster scope)
    convert: Callable[[Dict[str, Any]], Any]


RESOURCES: Dict[str, _Resource] = {
    r.obj_type: r
    for r in (
        _Resource("pod", "/api/v1/pods", convert_pod),
        _Resource("namespace", "/api/v1/namespaces", convert_namespace),
        _Resource("policy", "/apis/networking.k8s.io/v1/networkpolicies",
                  convert_policy),
        _Resource("service", "/api/v1/services", convert_service),
        _Resource("endpoints", "/api/v1/endpoints", convert_endpoints),
        _Resource("node", "/api/v1/nodes", convert_node),
    )
}


# --------------------------------------------------------------------------
# the list-watch source
# --------------------------------------------------------------------------

class KubernetesListWatch(K8sListWatch):
    """K8sListWatch over a live API server for one resource type.

    Maintains a model-object cache keyed by store key. On watch-stream
    loss it re-lists and diffs against the cache, synthesizing
    add/update/delete — reconnects are invisible to the Reflector
    (informer semantics; reference relies on client-go for the same).
    """

    RECONNECT_BACKOFF = (0.2, 5.0)

    def __init__(self, api: K8sApi, resource: _Resource):
        self.api = api
        self.resource = resource
        self._handlers: List[Tuple[Callable, Callable, Callable]] = []
        self._cache: Dict[str, Any] = {}
        self._rv = "0"
        # whether the cache is a baseline a subscriber has seen (set by
        # list() and by the watch thread's first re-list): a re-list
        # diffs, and dispatches, only against one
        self._baseline = False
        # One RLock serializes every cache mutation WITH its fetch and
        # dispatch: a reflector-driven list() racing the watch thread's
        # re-list could otherwise swap the cache backwards (stale fetch
        # wins) and emit reversed diffs. RLock because a dispatched
        # handler may synchronously call list() back (reflector resync).
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- K8sListWatch interface ---
    def list(self) -> List[Any]:
        with self._lock:
            raw = self.api.get_list(self.resource.path)
            items = [self.resource.convert(o)
                     for o in raw.get("items") or []]
            self._rv = (raw.get("metadata") or {}).get("resourceVersion", "0")
            self._cache = {m.key(): m for m in items}
            self._baseline = True
            return items

    def subscribe(self, on_add, on_update, on_delete) -> None:
        self._handlers.append((on_add, on_update, on_delete))
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._watch_loop, daemon=True,
                name=f"k8s-watch-{self.resource.obj_type}",
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    # --- internals ---
    def _dispatch(self, idx: int, *args: Any) -> None:
        for handlers in list(self._handlers):
            try:
                handlers[idx](*args)
            except Exception:
                log.exception("%s handler raised", self.resource.obj_type)

    def _relist_and_diff(self) -> None:
        with self._lock:
            raw = self.api.get_list(self.resource.path)
            items = {m.key(): m
                     for m in (self.resource.convert(o)
                               for o in raw.get("items") or [])}
            old = self._cache
            self._cache = items
            self._rv = (raw.get("metadata") or {}).get(
                "resourceVersion", "0")
            if not self._baseline:
                # no list() yet: the subscriber's own list is its
                # baseline, and adds dispatched now would race it
                self._baseline = True
                return
            for key, m in items.items():
                prev = old.get(key)
                if prev is None:
                    self._dispatch(0, m)
                elif prev.to_dict() != m.to_dict():
                    self._dispatch(1, prev, m)
            for key, prev in old.items():
                if key not in items:
                    self._dispatch(2, prev)

    def _watch_loop(self) -> None:
        backoff, cap = self.RECONNECT_BACKOFF
        needs_list = True
        while not self._stop.is_set():
            try:
                if needs_list:
                    self._relist_and_diff()
                    needs_list = False
                with self._lock:
                    rv = self._rv
                for ev in self.api.watch(self.resource.path, rv):
                    if self._stop.is_set():
                        return
                    self._handle_event(ev)
                # Clean stream end (server timeoutSeconds elapsed): the
                # tracked resourceVersion is current — re-watch from it.
                # A full re-list here would re-GET the whole collection
                # every ~5 minutes for zero information; listing is only
                # for errors/410 where continuity is actually lost.
                backoff = self.RECONNECT_BACKOFF[0]
            except Exception as exc:  # noqa: BLE001 — reconnect on anything
                if self._stop.is_set():
                    return
                needs_list = True
                log.warning("%s watch lost (%s); re-listing in %.1fs",
                            self.resource.obj_type, exc, backoff)
                self._stop.wait(backoff)
                backoff = min(backoff * 2, cap)

    def _handle_event(self, ev: Dict[str, Any]) -> None:
        etype = ev.get("type")
        obj = ev.get("object") or {}
        if etype == "BOOKMARK":
            with self._lock:
                self._rv = (_meta(obj)).get("resourceVersion", self._rv)
            return
        if etype == "ERROR":
            # e.g. 410 Gone: raise to trigger re-list + diff
            raise RuntimeError(f"watch error event: {obj.get('message')}")
        m = self.resource.convert(obj)
        rv = _meta(obj).get("resourceVersion")
        with self._lock:
            if rv:
                self._rv = rv
            prev = self._cache.get(m.key())
            if etype in ("ADDED", "MODIFIED"):
                self._cache[m.key()] = m
            elif etype == "DELETED":
                self._cache.pop(m.key(), None)
            if etype == "ADDED":
                # A re-delivered ADDED for a known object is an update
                if prev is None:
                    self._dispatch(0, m)
                elif prev.to_dict() != m.to_dict():
                    self._dispatch(1, prev, m)
            elif etype == "MODIFIED":
                self._dispatch(1, prev, m)
            elif etype == "DELETED":
                self._dispatch(2, m)
            else:
                log.warning("unknown watch event type %r", etype)


def make_k8s_sources(
    kubeconfig: Optional[str] = None,
    config: Optional[K8sApiConfig] = None,
    api: Optional[K8sApi] = None,
) -> Dict[str, KubernetesListWatch]:
    """Build the six reflector sources against a real API server.

    ``kubeconfig`` may be a path or the literal ``"in-cluster"``.
    """
    if api is None:
        if config is None:
            if kubeconfig in (None, "", "in-cluster"):
                config = K8sApiConfig.in_cluster()
            else:
                config = K8sApiConfig.from_kubeconfig(kubeconfig)
        api = K8sApi(config)
    return {
        obj_type: KubernetesListWatch(api, res)
        for obj_type, res in RESOURCES.items()
    }
