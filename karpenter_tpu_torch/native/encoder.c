/* Native encoder hot loop: pod signature + group bucketing.
 *
 * The solver's cold-start budget at 50k pods is dominated by computing each
 * pod's scheduling-identity signature and bucketing pods into groups —
 * ~300ms of pure CPython attribute traversal and small-tuple churn
 * (karpenter_tpu_torch/solver/encode.py:_signature / group_pods). This module does
 * the same walk with the C API: one pass, no bytecode dispatch, no
 * intermediate lists. The reference keeps its scheduler entirely in compiled
 * Go (bin-packing.md:16-43); this is the analogous native runtime component
 * for the Python control plane.
 *
 * Semantics contract (kept in lockstep with encode._signature):
 *   - the signature tuple layout is (requests_items, node_selector_items,
 *     req_terms, tolerations, spread, affinity, labels_items)
 *   - pods with any "complex" field non-empty (required_affinity_terms,
 *     tolerations, topology_spread, affinity_terms) — or carrying a gang /
 *     priority component (nonzero priority, annotation-form pod-group key) —
 *     are signed by calling back into the Python _signature; only the
 *     dominant simple shape is specialized here
 *   - items tuples are insertion-ordered (see encode._items_t for why that
 *     is safe for grouping)
 *   - the computed signature is cached on pod.__dict__["_sched_sig"] with
 *     the exact same key the Python path uses, so the two implementations
 *     interoperate on warm pods
 *
 * Columnar-warm grouping: the run-adjacency fast path STAMPS the run
 * leader's signature object onto every matched member, so the next encode of
 * the same pods takes a cached-signature POINTER compare per pod instead of
 * re-walking eleven fields — the warm fresh-encode loop drops from ~0.4us to
 * ~0.1us per pod. Stamping a member with the leader's (value-equal) tuple is
 * the same merge tolerance matches_prev already applies: it can only keep
 * together what the insertion-ordered signature might have split into
 * equivalent groups, never mix distinct scheduling identities.
 *
 * Exposed API:
 *   group_pods(pods, py_signature) -> list[list[pod]]
 *   join_names(pods, sep) -> bytes   (the problem-digest name blob)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *sig_key = NULL; /* interned "_sched_sig" */
static PyObject *s_required_affinity_terms, *s_tolerations, *s_topology_spread,
    *s_affinity_terms, *s_requests, *s_r, *s_node_selector, *s_meta, *s_labels,
    *s_name, *s_preferred_affinity_terms, *s_volume_zones, *s_priority,
    *s_annotations,
    *pod_group_key, /* "karpenter.tpu/pod-group" (lockstep with labels.POD_GROUP) */
    *spot_div_key,  /* "karpenter.tpu/spot-diversification-max-frac"
                     * (lockstep with labels.SPOT_DIVERSIFICATION) */
    *slice_adj_key; /* "karpenter.tpu/slice-adjacency"
                     * (lockstep with labels.SLICE_ADJACENCY) */

/* tuple(d.items()) for a dict; () for empty/non-dict (caller validates). */
static PyObject *
items_tuple(PyObject *d)
{
    Py_ssize_t n, pos = 0, i = 0;
    PyObject *out, *k, *v;

    if (d == NULL || !PyDict_Check(d) || (n = PyDict_Size(d)) == 0)
        return PyTuple_New(0);
    out = PyTuple_New(n);
    if (out == NULL)
        return NULL;
    while (PyDict_Next(d, &pos, &k, &v)) {
        PyObject *pair = PyTuple_Pack(2, k, v);
        if (pair == NULL) {
            Py_DECREF(out);
            return NULL;
        }
        PyTuple_SET_ITEM(out, i++, pair);
    }
    return out;
}

/* Field read that prefers the instance dict we already hold: Pod is a plain
 * dataclass, so every field is an instance-dict entry and the full attribute
 * protocol (type MRO scan for a data descriptor, then the dict) is pure
 * overhead x11 reads x50k pods. Falls back to GetAttr for exotic subclasses
 * that turn a field into a property. Returns a NEW reference. */
static PyObject *
field_get(PyObject *obj, PyObject *idict, PyObject *name)
{
    if (idict != NULL) {
        PyObject *v = PyDict_GetItemWithError(idict, name);
        if (v != NULL) {
            Py_INCREF(v);
            return v;
        }
        if (PyErr_Occurred())
            return NULL;
    }
    return PyObject_GetAttr(obj, name);
}

/* True when the field is a non-empty sequence (list). -1 on error. */
static int
nonempty_list_attr(PyObject *obj, PyObject *idict, PyObject *name)
{
    PyObject *a = field_get(obj, idict, name);
    Py_ssize_t n;
    if (a == NULL)
        return -1;
    n = PyList_CheckExact(a) ? PyList_GET_SIZE(a) : PyObject_Length(a);
    Py_DECREF(a);
    if (n < 0)
        return -1;
    return n > 0;
}

/* Gang/priority carrier check: encode._signature appends a gang component
 * for pods with a nonzero priority or an annotation-form pod-group key, so
 * those pods must take the Python signature path (and never merge through
 * the adjacency fast path — a gang member must not bucket with an
 * otherwise-identical plain pod). Returns 1 when the pod carries either,
 * 0 otherwise, -1 on error. */
static int
gang_or_priority(PyObject *pod, PyObject *idict)
{
    PyObject *prio, *meta, *ann;
    int truthy;

    prio = field_get(pod, idict, s_priority);
    if (prio == NULL)
        return -1;
    truthy = PyObject_IsTrue(prio);
    Py_DECREF(prio);
    if (truthy != 0)
        return truthy; /* nonzero priority or error */
    meta = field_get(pod, idict, s_meta);
    if (meta == NULL)
        return -1;
    ann = PyObject_GetAttr(meta, s_annotations);
    Py_DECREF(meta);
    if (ann == NULL)
        return -1;
    if (PyDict_CheckExact(ann)) {
        if (PyDict_GET_SIZE(ann) == 0) {
            Py_DECREF(ann);
            return 0;
        }
        truthy = PyDict_Contains(ann, pod_group_key);
        if (truthy == 0)
            truthy = PyDict_Contains(ann, spot_div_key);
        if (truthy == 0)
            truthy = PyDict_Contains(ann, slice_adj_key);
    } else {
        truthy = PySequence_Contains(ann, pod_group_key);
        if (truthy == 0)
            truthy = PySequence_Contains(ann, spot_div_key);
        if (truthy == 0)
            truthy = PySequence_Contains(ann, slice_adj_key);
    }
    Py_DECREF(ann);
    return truthy;
}

static PyObject *
signature_for(PyObject *pod, PyObject *py_signature, int *simple_out)
{
    PyObject *dict, *sig, *meta = NULL, *labels = NULL, *requests = NULL,
             *r_map = NULL, *nodesel = NULL, *req_items = NULL,
             *sel_items = NULL, *lab_items = NULL, *empty;
    int complex_shape;

    if (simple_out)
        *simple_out = 0;
    /* cached? (written by either implementation) */
    dict = PyObject_GenericGetDict(pod, NULL);
    if (dict == NULL)
        return NULL;
    sig = PyDict_GetItemWithError(dict, sig_key);
    if (sig != NULL) {
        Py_INCREF(sig);
        Py_DECREF(dict);
        return sig;
    }
    if (PyErr_Occurred()) {
        Py_DECREF(dict);
        return NULL;
    }

    complex_shape = nonempty_list_attr(pod, dict, s_required_affinity_terms);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, dict, s_tolerations);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, dict, s_topology_spread);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, dict, s_affinity_terms);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, dict, s_preferred_affinity_terms);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, dict, s_volume_zones);
    if (complex_shape == 0)
        complex_shape = gang_or_priority(pod, dict);
    if (complex_shape < 0) {
        Py_DECREF(dict);
        return NULL;
    }
    if (complex_shape) {
        /* rare shape: defer to the Python implementation (it caches too) */
        Py_DECREF(dict);
        return PyObject_CallFunctionObjArgs(py_signature, pod, NULL);
    }

    requests = field_get(pod, dict, s_requests);
    if (requests == NULL)
        goto fail;
    /* Resources uses __slots__ — _r is a member descriptor, not a dict entry */
    r_map = PyObject_GetAttr(requests, s_r);
    if (r_map == NULL)
        goto fail;
    nodesel = field_get(pod, dict, s_node_selector);
    if (nodesel == NULL)
        goto fail;
    meta = field_get(pod, dict, s_meta);
    if (meta == NULL)
        goto fail;
    labels = PyObject_GetAttr(meta, s_labels);
    if (labels == NULL)
        goto fail;

    req_items = items_tuple(r_map);
    sel_items = items_tuple(nodesel);
    lab_items = items_tuple(labels);
    if (req_items == NULL || sel_items == NULL || lab_items == NULL)
        goto fail;

    empty = PyTuple_New(0);
    if (empty == NULL)
        goto fail;
    /* (requests, node_selector, (), (), (), (), labels, (), ()) — the same
     * 9-tuple layout encode._signature builds for the simple shape */
    sig = PyTuple_Pack(9, req_items, sel_items, empty, empty, empty, empty,
                       lab_items, empty, empty);
    Py_DECREF(empty);
    if (sig == NULL)
        goto fail;

    if (simple_out)
        *simple_out = 1;
    if (PyDict_SetItem(dict, sig_key, sig) < 0) {
        Py_DECREF(sig);
        goto fail;
    }
    Py_DECREF(req_items);
    Py_DECREF(sel_items);
    Py_DECREF(lab_items);
    Py_DECREF(labels);
    Py_DECREF(meta);
    Py_DECREF(nodesel);
    Py_DECREF(r_map);
    Py_DECREF(requests);
    Py_DECREF(dict);
    return sig;

fail:
    Py_XDECREF(req_items);
    Py_XDECREF(sel_items);
    Py_XDECREF(lab_items);
    Py_XDECREF(labels);
    Py_XDECREF(meta);
    Py_XDECREF(nodesel);
    Py_XDECREF(r_map);
    Py_XDECREF(requests);
    Py_DECREF(dict);
    return NULL;
}

/* Adjacency fast path: pods of one controller arrive in runs of identical
 * spec. When the current pod's scheduling-relevant fields VALUE-equal the
 * previous (simple-shape) pod's, it belongs to the same group — append and
 * move on: no signature tuple, no instance-dict materialization, no bucket
 * hash. Value equality can only MERGE what the insertion-ordered signature
 * would split into equivalent groups (see encode._items_t), never mix
 * distinct scheduling identities.
 *
 * prev_* are borrowed caches of the run leader's field objects. Returns 1 on
 * match, 0 on mismatch (including complex shape), -1 on error. */
static int
matches_prev(PyObject *pod, PyObject *prev_r, PyObject *prev_sel,
             PyObject *prev_labels)
{
    PyObject *requests, *r_map, *nodesel, *meta, *labels;
    int eq, complex_shape;

    complex_shape = nonempty_list_attr(pod, NULL, s_required_affinity_terms);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, NULL, s_tolerations);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, NULL, s_topology_spread);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, NULL, s_affinity_terms);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, NULL, s_preferred_affinity_terms);
    if (complex_shape == 0)
        complex_shape = nonempty_list_attr(pod, NULL, s_volume_zones);
    if (complex_shape == 0)
        complex_shape = gang_or_priority(pod, NULL);
    if (complex_shape != 0)
        return complex_shape < 0 ? -1 : 0;

    requests = PyObject_GetAttr(pod, s_requests);
    if (requests == NULL)
        return -1;
    r_map = PyObject_GetAttr(requests, s_r);
    Py_DECREF(requests);
    if (r_map == NULL)
        return -1;
    eq = PyObject_RichCompareBool(r_map, prev_r, Py_EQ);
    Py_DECREF(r_map);
    if (eq != 1)
        return eq;

    nodesel = PyObject_GetAttr(pod, s_node_selector);
    if (nodesel == NULL)
        return -1;
    eq = PyObject_RichCompareBool(nodesel, prev_sel, Py_EQ);
    Py_DECREF(nodesel);
    if (eq != 1)
        return eq;

    meta = PyObject_GetAttr(pod, s_meta);
    if (meta == NULL)
        return -1;
    labels = PyObject_GetAttr(meta, s_labels);
    Py_DECREF(meta);
    if (labels == NULL)
        return -1;
    eq = PyObject_RichCompareBool(labels, prev_labels, Py_EQ);
    Py_DECREF(labels);
    return eq;
}

/* Cache the run leader's comparison fields. Returns 0 ok, -1 error. */
static int
load_prev(PyObject *pod, PyObject **prev_r, PyObject **prev_sel,
          PyObject **prev_labels)
{
    PyObject *requests, *meta;

    Py_CLEAR(*prev_r);
    Py_CLEAR(*prev_sel);
    Py_CLEAR(*prev_labels);
    requests = PyObject_GetAttr(pod, s_requests);
    if (requests == NULL)
        return -1;
    *prev_r = PyObject_GetAttr(requests, s_r);
    Py_DECREF(requests);
    if (*prev_r == NULL)
        return -1;
    *prev_sel = PyObject_GetAttr(pod, s_node_selector);
    if (*prev_sel == NULL)
        return -1;
    meta = PyObject_GetAttr(pod, s_meta);
    if (meta == NULL)
        return -1;
    *prev_labels = PyObject_GetAttr(meta, s_labels);
    Py_DECREF(meta);
    if (*prev_labels == NULL)
        return -1;
    return 0;
}

/* group_pods(pods, py_signature) -> list of lists of pods, in first-seen
 * signature order. */
static PyObject *
group_pods_c(PyObject *self, PyObject *args)
{
    PyObject *pods, *py_signature, *buckets = NULL, *order = NULL, *seq = NULL;
    PyObject *prev_r = NULL, *prev_sel = NULL, *prev_labels = NULL;
    PyObject *prev_members = NULL; /* borrowed (owned by order) */
    PyObject *prev_sig = NULL;     /* owned: the last group's signature */
    Py_ssize_t n, i;

    if (!PyArg_ParseTuple(args, "OO", &pods, &py_signature))
        return NULL;
    seq = PySequence_Fast(pods, "pods must be a sequence");
    if (seq == NULL)
        return NULL;
    n = PySequence_Fast_GET_SIZE(seq);
    buckets = PyDict_New();  /* sig -> list[pod] */
    order = PyList_New(0);   /* list[list[pod]] in first-seen order */
    if (buckets == NULL || order == NULL)
        goto fail;

    for (i = 0; i < n; i++) {
        PyObject *pod = PySequence_Fast_GET_ITEM(seq, i); /* borrowed */
        PyObject *sig, *members, *dict;
        int simple = 0;

        /* cached-signature fast path: a pod stamped on an earlier encode
         * (by signature_for, the Python _signature, or the member-stamping
         * below) resolves by one dict probe; a POINTER match against the
         * previous pod's signature appends without even a bucket hash —
         * the dominant warm-encode case, since run members share the
         * leader's signature object. */
        dict = PyObject_GenericGetDict(pod, NULL);
        if (dict == NULL)
            goto fail;
        sig = PyDict_GetItemWithError(dict, sig_key); /* borrowed */
        if (sig == NULL && PyErr_Occurred()) {
            Py_DECREF(dict);
            goto fail;
        }
        if (sig != NULL && sig == prev_sig && prev_members != NULL) {
            Py_DECREF(dict);
            if (PyList_Append(prev_members, pod) < 0)
                goto fail;
            continue;
        }
        if (sig == NULL && prev_members != NULL && prev_r != NULL) {
            int same = matches_prev(pod, prev_r, prev_sel, prev_labels);
            if (same < 0) {
                Py_DECREF(dict);
                goto fail;
            }
            if (same) {
                /* stamp the run's signature so the NEXT encode of this pod
                 * takes the pointer path above (value-equal merge, see the
                 * module comment) */
                if (prev_sig != NULL &&
                    PyDict_SetItem(dict, sig_key, prev_sig) < 0) {
                    Py_DECREF(dict);
                    goto fail;
                }
                Py_DECREF(dict);
                if (PyList_Append(prev_members, pod) < 0)
                    goto fail;
                continue;
            }
        }
        if (sig != NULL) {
            Py_INCREF(sig);
            Py_DECREF(dict);
            /* simplicity unknown for an externally-cached signature: keep
             * the pointer fast path armed but disable the value-compare
             * (matches_prev merging against a possibly-complex pod would
             * ignore its constraint fields) */
            simple = -1;
        } else {
            Py_DECREF(dict);
            sig = signature_for(pod, py_signature, &simple);
            if (sig == NULL)
                goto fail;
        }
        members = PyDict_GetItemWithError(buckets, sig); /* borrowed */
        if (members == NULL) {
            if (PyErr_Occurred()) {
                Py_DECREF(sig);
                goto fail;
            }
            members = PyList_New(0);
            if (members == NULL || PyDict_SetItem(buckets, sig, members) < 0 ||
                PyList_Append(order, members) < 0) {
                Py_XDECREF(members);
                Py_DECREF(sig);
                goto fail;
            }
            Py_DECREF(members); /* owned by buckets + order now */
        }
        Py_XSETREF(prev_sig, sig); /* transfer: prev_sig owns it now */
        if (PyList_Append(members, pod) < 0)
            goto fail;
        if (simple == 1) {
            if (load_prev(pod, &prev_r, &prev_sel, &prev_labels) < 0)
                goto fail;
            prev_members = members;
        } else {
            Py_CLEAR(prev_r);
            Py_CLEAR(prev_sel);
            Py_CLEAR(prev_labels);
            /* pointer matches still work off the cached signature */
            prev_members = (simple == -1) ? members : NULL;
        }
    }
    Py_XDECREF(prev_sig);
    Py_XDECREF(prev_r);
    Py_XDECREF(prev_sel);
    Py_XDECREF(prev_labels);
    Py_DECREF(buckets);
    Py_DECREF(seq);
    return order;

fail:
    Py_XDECREF(prev_sig);
    Py_XDECREF(prev_r);
    Py_XDECREF(prev_sel);
    Py_XDECREF(prev_labels);
    Py_XDECREF(buckets);
    Py_XDECREF(order);
    Py_XDECREF(seq);
    return NULL;
}

/* join_names(pods, sep) -> bytes: the UTF-8 encoding of
 * sep.join(p.meta.name for p in pods) — the problem-digest name blob,
 * byte-identical to the Python join (lockstep with solver.problem_digest).
 * One C pass instead of a 50k-iteration attribute walk + list build. */
static PyObject *
join_names_c(PyObject *self, PyObject *args)
{
    PyObject *pods, *sep, *seq = NULL, *names = NULL, *joined, *out;
    Py_ssize_t n, i;

    if (!PyArg_ParseTuple(args, "OU", &pods, &sep))
        return NULL;
    seq = PySequence_Fast(pods, "pods must be a sequence");
    if (seq == NULL)
        return NULL;
    n = PySequence_Fast_GET_SIZE(seq);
    names = PyList_New(n);
    if (names == NULL) {
        Py_DECREF(seq);
        return NULL;
    }
    for (i = 0; i < n; i++) {
        PyObject *pod = PySequence_Fast_GET_ITEM(seq, i); /* borrowed */
        PyObject *meta, *name;
        meta = PyObject_GetAttr(pod, s_meta);
        if (meta == NULL)
            goto fail;
        name = PyObject_GetAttr(meta, s_name);
        Py_DECREF(meta);
        if (name == NULL)
            goto fail;
        if (!PyUnicode_Check(name)) {
            Py_DECREF(name);
            PyErr_SetString(PyExc_TypeError, "pod name must be str");
            goto fail;
        }
        PyList_SET_ITEM(names, i, name); /* steals */
    }
    joined = PyUnicode_Join(sep, names);
    Py_DECREF(names);
    Py_DECREF(seq);
    if (joined == NULL)
        return NULL;
    out = PyUnicode_AsUTF8String(joined);
    Py_DECREF(joined);
    return out;

fail:
    Py_DECREF(names);
    Py_DECREF(seq);
    return NULL;
}

static PyMethodDef methods[] = {
    {"group_pods", group_pods_c, METH_VARARGS,
     "group_pods(pods, py_signature) -> list[list[pod]] bucketed by "
     "scheduling signature, first-seen order"},
    {"join_names", join_names_c, METH_VARARGS,
     "join_names(pods, sep) -> bytes: UTF-8 of sep.join(p.meta.name ...)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_encoder", NULL, -1, methods,
};

PyMODINIT_FUNC
PyInit__encoder(void)
{
    sig_key = PyUnicode_InternFromString("_sched_sig");
    s_required_affinity_terms = PyUnicode_InternFromString("required_affinity_terms");
    s_tolerations = PyUnicode_InternFromString("tolerations");
    s_topology_spread = PyUnicode_InternFromString("topology_spread");
    s_affinity_terms = PyUnicode_InternFromString("affinity_terms");
    s_requests = PyUnicode_InternFromString("requests");
    s_r = PyUnicode_InternFromString("_r");
    s_node_selector = PyUnicode_InternFromString("node_selector");
    s_meta = PyUnicode_InternFromString("meta");
    s_labels = PyUnicode_InternFromString("labels");
    s_name = PyUnicode_InternFromString("name");
    s_preferred_affinity_terms = PyUnicode_InternFromString("preferred_affinity_terms");
    s_volume_zones = PyUnicode_InternFromString("volume_zones");
    s_priority = PyUnicode_InternFromString("priority");
    s_annotations = PyUnicode_InternFromString("annotations");
    pod_group_key = PyUnicode_InternFromString("karpenter.tpu/pod-group");
    spot_div_key = PyUnicode_InternFromString(
        "karpenter.tpu/spot-diversification-max-frac");
    slice_adj_key = PyUnicode_InternFromString("karpenter.tpu/slice-adjacency");
    if (sig_key == NULL || s_required_affinity_terms == NULL ||
        s_tolerations == NULL || s_topology_spread == NULL ||
        s_affinity_terms == NULL || s_requests == NULL || s_r == NULL ||
        s_node_selector == NULL || s_meta == NULL || s_labels == NULL ||
        s_name == NULL ||
        s_preferred_affinity_terms == NULL || s_volume_zones == NULL ||
        s_priority == NULL || s_annotations == NULL || pod_group_key == NULL ||
        spot_div_key == NULL || slice_adj_key == NULL)
        return NULL;
    return PyModule_Create(&moduledef);
}
