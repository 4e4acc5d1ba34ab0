/* The span tracer's recorder in C (obs/tracer.py builds and loads it).
 *
 * A Ring holds the last `capacity` finished spans in preallocated slots:
 * name and attributes (references), start and end (seconds on
 * CLOCK_MONOTONIC, the clock of time.perf_counter on Linux) and the
 * thread.  Ring.span(name, attrs) makes a Span whose __enter__ reads the
 * clock and whose __exit__ reads it again and writes the slot.  Both run
 * as C methods under the GIL, so the serving path pays no Python frame
 * for them and a span's record is atomic with respect to other threads.
 * Ring.rows() returns the ring oldest first as (name, thread, start,
 * end, attrs) tuples.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pythread.h>
#include <time.h>

static double now_s(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

typedef struct {
    PyObject_HEAD
    Py_ssize_t cap;
    unsigned long long seq; /* spans recorded since made or cleared */
    PyObject **names, **attrs;
    double *t0, *t1;
    unsigned long *tid;
} Ring;

typedef struct {
    PyObject_HEAD
    Ring *ring;
    PyObject *name, *attrs;
    double t0;
} Span;

static PyTypeObject SpanType;

static void ring_drop_slots(Ring *r)
{
    for (Py_ssize_t i = 0; i < r->cap; i++) {
        Py_CLEAR(r->names[i]);
        Py_CLEAR(r->attrs[i]);
    }
    r->seq = 0;
}

static void Ring_dealloc(Ring *r)
{
    if (r->names && r->attrs)
        ring_drop_slots(r);
    PyMem_Free(r->names);
    PyMem_Free(r->attrs);
    PyMem_Free(r->t0);
    PyMem_Free(r->t1);
    PyMem_Free(r->tid);
    Py_TYPE(r)->tp_free((PyObject *)r);
}

static int Ring_init(Ring *r, PyObject *args, PyObject *kw)
{
    Py_ssize_t cap;
    if (!PyArg_ParseTuple(args, "n", &cap))
        return -1;
    if (cap < 1) {
        PyErr_SetString(PyExc_ValueError, "capacity must be >= 1");
        return -1;
    }
    if (r->names) {
        PyErr_SetString(PyExc_RuntimeError, "Ring is already initialized");
        return -1;
    }
    r->cap = cap;
    r->names = PyMem_Calloc(cap, sizeof(PyObject *));
    r->attrs = PyMem_Calloc(cap, sizeof(PyObject *));
    r->t0 = PyMem_Calloc(cap, sizeof(double));
    r->t1 = PyMem_Calloc(cap, sizeof(double));
    r->tid = PyMem_Calloc(cap, sizeof(unsigned long));
    if (!r->names || !r->attrs || !r->t0 || !r->t1 || !r->tid) {
        PyErr_NoMemory();
        return -1;
    }
    return 0;
}

static PyObject *Ring_span(Ring *r, PyObject *const *args, Py_ssize_t n)
{
    if (n != 2 || !PyDict_Check(args[1])) {
        PyErr_SetString(PyExc_TypeError, "span(name, attrs: dict)");
        return NULL;
    }
    Span *s = PyObject_New(Span, &SpanType);
    if (!s)
        return NULL;
    Py_INCREF(r);
    s->ring = r;
    Py_INCREF(args[0]);
    s->name = args[0];
    Py_INCREF(args[1]);
    s->attrs = args[1];
    s->t0 = 0.0;
    return (PyObject *)s;
}

static PyObject *Ring_rows(Ring *r, PyObject *unused)
{
    unsigned long long cap = (unsigned long long)r->cap;
    Py_ssize_t n = (Py_ssize_t)(r->seq < cap ? r->seq : cap);
    unsigned long long first = r->seq - (unsigned long long)n;
    PyObject *out = PyList_New(n);
    if (!out)
        return NULL;
    for (Py_ssize_t k = 0; k < n; k++) {
        Py_ssize_t i = (Py_ssize_t)((first + (unsigned long long)k) % cap);
        PyObject *row = Py_BuildValue("(OkddO)", r->names[i], r->tid[i],
                                      r->t0[i], r->t1[i], r->attrs[i]);
        if (!row) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, k, row);
    }
    return out;
}

static PyObject *Ring_clear(Ring *r, PyObject *unused)
{
    ring_drop_slots(r);
    Py_RETURN_NONE;
}

static PyObject *Ring_recorded(Ring *r, void *closure)
{
    return PyLong_FromUnsignedLongLong(r->seq);
}

static PyMethodDef Ring_methods[] = {
    {"span", (PyCFunction)(void (*)(void))Ring_span, METH_FASTCALL,
     "span(name, attrs) -> a span that records into this ring"},
    {"rows", (PyCFunction)Ring_rows, METH_NOARGS,
     "finished spans, oldest first: (name, thread, start, end, attrs)"},
    {"clear", (PyCFunction)Ring_clear, METH_NOARGS, "drop every span"},
    {NULL, NULL, 0, NULL},
};

static PyGetSetDef Ring_getset[] = {
    {"recorded", (getter)Ring_recorded, NULL,
     "spans recorded since made or cleared", NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PyTypeObject RingType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "spanring.Ring",
    .tp_basicsize = sizeof(Ring),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Ring(capacity): the last `capacity` finished spans",
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)Ring_init,
    .tp_dealloc = (destructor)Ring_dealloc,
    .tp_methods = Ring_methods,
    .tp_getset = Ring_getset,
};

static void Span_dealloc(Span *s)
{
    Py_XDECREF(s->ring);
    Py_XDECREF(s->name);
    Py_XDECREF(s->attrs);
    PyObject_Free(s);
}

static PyObject *Span_enter(Span *s, PyObject *unused)
{
    s->t0 = now_s();
    Py_INCREF(s);
    return (PyObject *)s;
}

static PyObject *Span_exit(Span *s, PyObject *const *args, Py_ssize_t n)
{
    double t1 = now_s();
    if (n >= 1 && args[0] != Py_None) {
        /* attrs.setdefault("error", exc_type.__name__) */
        PyObject *key = PyUnicode_FromString("error");
        PyObject *nm = key ? PyObject_GetAttrString(args[0], "__name__")
                           : NULL;
        PyObject *got = nm ? PyDict_SetDefault(s->attrs, key, nm) : NULL;
        Py_XDECREF(nm);
        Py_XDECREF(key);
        if (!got)
            return NULL;
    }
    Ring *r = s->ring;
    Py_ssize_t i = (Py_ssize_t)(r->seq % (unsigned long long)r->cap);
    PyObject *old_name = r->names[i], *old_attrs = r->attrs[i];
    Py_INCREF(s->name);
    r->names[i] = s->name;
    Py_INCREF(s->attrs);
    r->attrs[i] = s->attrs;
    r->t0[i] = s->t0;
    r->t1[i] = t1;
    r->tid[i] = PyThread_get_thread_ident();
    r->seq++;
    /* last: a freed attribute may run arbitrary code */
    Py_XDECREF(old_name);
    Py_XDECREF(old_attrs);
    Py_RETURN_FALSE;
}

static PyObject *Span_set(Span *s, PyObject *args, PyObject *kw)
{
    if (PyTuple_GET_SIZE(args) != 0) {
        PyErr_SetString(PyExc_TypeError, "set() takes keyword attributes");
        return NULL;
    }
    if (kw && PyDict_Update(s->attrs, kw) < 0)
        return NULL;
    Py_INCREF(s);
    return (PyObject *)s;
}

static PyMethodDef Span_methods[] = {
    {"__enter__", (PyCFunction)Span_enter, METH_NOARGS, NULL},
    {"__exit__", (PyCFunction)(void (*)(void))Span_exit, METH_FASTCALL,
     NULL},
    {"set", (PyCFunction)(void (*)(void))Span_set,
     METH_VARARGS | METH_KEYWORDS, "attach attributes before exit"},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject SpanType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "spanring.Span",
    .tp_basicsize = sizeof(Span),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_dealloc = (destructor)Span_dealloc,
    .tp_methods = Span_methods,
};

static PyObject *mod_now(PyObject *self, PyObject *unused)
{
    return PyFloat_FromDouble(now_s());
}

static PyMethodDef mod_methods[] = {
    {"now", mod_now, METH_NOARGS, "the spans' clock, in seconds"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef spanring_module = {
    PyModuleDef_HEAD_INIT, "spanring", NULL, -1, mod_methods,
};

PyMODINIT_FUNC PyInit_spanring(void)
{
    if (PyType_Ready(&RingType) < 0 || PyType_Ready(&SpanType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&spanring_module);
    if (!m)
        return NULL;
    Py_INCREF(&RingType);
    if (PyModule_AddObject(m, "Ring", (PyObject *)&RingType) < 0) {
        Py_DECREF(&RingType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
